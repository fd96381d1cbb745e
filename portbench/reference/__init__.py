"""The plain reference: a StarCoder2-style dense language model, its loss,
gradients and AdamW, in PyTorch float32 with TF32 off.  It imports
nothing of the measured program: it reads the configuration's sizes and
the seed's initial weights by name, and works out everything else
again."""
