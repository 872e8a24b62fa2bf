"""Alignment on PyTorch: chain DP and affine-gap DP kernels, and the
port's SpliceAligner."""
