"""Core: the planning math (cost, comm and timeline models, schedules),
the parameter-to-bucket mapping, the gradient sync engine and the
trainer.  Import the submodules directly; this package ``__init__``
imports nothing, so the planning math loads without the trainer."""
