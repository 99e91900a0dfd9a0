"""Attention ops: the flash forward, the paged decode, int8 quantization,
and the nvcc build of the CUDA kernels behind them (``build.py``)."""
