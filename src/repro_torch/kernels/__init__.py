"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Ported so far: ``comm_pack`` (the gradient-arena wire path).
The flash-attention, RG-LRU and RWKV6 kernels are still to port."""
