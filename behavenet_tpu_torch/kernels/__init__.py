"""Hand-written CUDA C++ kernels for sm_90a and their build (``build.py``)."""
