"""PnP, the image-domain ArUco detector and the wrappers of its CUDA
kernels (``cuda_cc``, ``cuda_subpix``)."""
