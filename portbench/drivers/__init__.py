"""One module per kind of cell; a workload file names its driver."""
