"""Hand-written CUDA kernels of the port, one package per TPU kernel of the
reference (``repro.kernels``): ``<name>/ops.py`` is the wrapper (checks,
launch count, CUDA launch, registered as a ``torch.library`` custom op so a
fake-tensor capture traces through it) and ``<name>/ref.py`` the plain
PyTorch version that the wrapper runs for CPU tensors."""
