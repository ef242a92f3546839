"""Hand-written CUDA kernels of the serving and training paths (sources in
``csrc/``), their wrappers and plain PyTorch versions (``ref``), the ctypes
build (``_build``) and the dispatch layer every quantized linear and
attention call goes through (``dispatch.qmatmul`` /
``dispatch.qattention``).  Nothing here is compiled or loaded at import
time."""
