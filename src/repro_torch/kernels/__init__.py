"""Simplex kernels of the port: CUDA C++ for Hopper plus plain PyTorch.

``engine`` launches the MAP/ACCUM/EDM/CA bodies over any schedule,
``ops`` holds the public entry points, ``ref`` the dense oracles,
``legacy`` the frozen originals (the engine's independent
differential baseline), ``hmap_mxu`` the tensor-core H map of the
paper's §7.1, ``simplex_kernels`` the deprecated shims,
``policy`` the device policy and ``_build`` the nvcc build.  Importing
the package builds nothing: the kernels are compiled on first use.
"""
