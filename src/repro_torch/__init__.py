"""PyTorch and CUDA port of the m-simplex thread-map library.

``repro_torch`` mirrors ``repro``'s layout: ``core/`` holds the block
maps and schedules (numpy or torch), ``kernels/`` the MAP, ACCUM, EDM
and CA kernels written in CUDA C++ for Hopper with a plain PyTorch
version beside each.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
