"""Hand-written CUDA kernels of the port, their build, and their plain
PyTorch versions. ``router_match`` holds the router's topic and headers
match kernels (``csrc/router_match.cu``)."""
