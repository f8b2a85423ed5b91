"""Hand-written CUDA kernels for MKOR's hot loop (sources in ``csrc/``),
their ctypes bindings, plain PyTorch versions and the banked entry points
(``ops``).  Nothing here compiles or loads CUDA code at import time."""
