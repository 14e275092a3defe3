"""Device policy for every kernel entry point of the port.

* ``resolve_device(device)`` — an entry point's ``device=None`` means
  the card.  Without a CUDA device that raises ``RuntimeError`` naming
  ``device="cpu"``; it never falls back to the CPU on its own.
* Dispatch follows the tensor: a CUDA tensor always launches the
  hand-written kernel, a CPU tensor always takes the kernel's plain
  PyTorch version.  There is no environment override and no ``try``
  that gives way to the plain version when a build or launch fails.
* ``check_tile`` is the launch contract these kernels have: ``rho``
  divides ``n``, the tile fits one block's threads by looping, and its
  shared-memory footprint fits what a Hopper block may use.
* ``card_operand`` is what a kernel wrapper holds each tensor to before
  any build or launch: on the card, of a dtype the kernel takes,
  contiguous.
* ``DTYPE_CODES`` numbers the element types of the simplex kernels as
  ``kernels/csrc/dtypes.cuh`` does; ``ACCUM_DTYPES``, ``CA_DTYPES`` and
  ``EDM_DTYPES`` are the types each family takes on the card, the
  reference's: ACCUM and CA run in the array's own type, EDM computes in
  float32 and returns the points' floating type.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "SMEM_LIMIT",
    "DTYPE_CODES",
    "ACCUM_DTYPES",
    "CA_DTYPES",
    "EDM_DTYPES",
    "MAX_M",
    "resolve_device",
    "on_card",
    "check_tile",
    "card_operand",
]

# Shared memory one block may use on sm_90 (227 KB, opt-in above 48 KB).
SMEM_LIMIT = 232_448
# Dimensions the device maps serve (SIMPLEX_MAX_M in simplex_maps.cuh).
MAX_M = 8

# Element type codes of kernels/csrc/dtypes.cuh (enum SimplexDtype).
DTYPE_CODES = {
    torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3, torch.int8: 4,
    torch.uint8: 5, torch.int16: 6, torch.bfloat16: 7, torch.float16: 8,
}
# +1 in place (accum.cu, legacy ACCUM): every coded type.
ACCUM_DTYPES = tuple(DTYPE_CODES)
# One Life step in the state's own type (ca.cu, legacy CA): all but float64.
CA_DTYPES = tuple(t for t in DTYPE_CODES if t is not torch.float64)
# Distances in float32, stored in the points' type (edm.cu, legacy EDM).
EDM_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on (None -> the card).

    Args:
        device: ``None`` for CUDA, or anything ``torch.device`` takes.

    Returns:
        The resolved ``torch.device``.

    Raises:
        RuntimeError: ``device`` is None and no CUDA device is present.

    Example:
        >>> resolve_device("cpu")
        device(type='cpu')
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the "
                "kernels' plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one or a
    ``meta`` one: the plain version, which on ``meta`` tensors computes
    nothing but shapes (the dry run counts a step's FLOPs so).

    Raises:
        ValueError: for a tensor on any other device.
    """
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what}: no kernel for tensors on {t.device}")


def check_tile(name: str, m: int, n: int, rho: Optional[int],
               smem_bytes: int = 0) -> None:
    """Enforce the kernels' launch contract before a launch.

    Args:
        name: Kernel name, for messages.
        m: Simplex dimension.
        n: Side length in elements.
        rho: Tile side.
        smem_bytes: Dynamic shared memory one block of the launch needs.

    Raises:
        ValueError: rho does not divide n, m is out of range, or the
            tile's shared memory does not fit a block.

    Example:
        >>> check_tile("accum", 2, 16, 4)
        >>> check_tile("accum", 2, 16, 5)
        Traceback (most recent call last):
        ...
        ValueError: accum: rho=5 must divide n=16
    """
    if not 2 <= m <= MAX_M:
        raise ValueError(f"{name}: m={m} outside the device maps' 2..{MAX_M}")
    if rho is None or rho < 1 or n % rho:
        raise ValueError(f"{name}: rho={rho} must divide n={n}")
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"{name}: a tile needs {smem_bytes} bytes of shared memory, more "
            f"than the {SMEM_LIMIT} a Hopper block may use; lower rho"
        )


def card_operand(t: torch.Tensor, name: str, dtypes) -> None:
    """Refuse a tensor a CUDA kernel cannot take.

    Args:
        t: The operand.
        name: Kernel name, for messages.
        dtypes: The dtypes the kernel is built for.

    Raises:
        ValueError: ``t`` is not on a CUDA device, not of one of
            ``dtypes``, or not contiguous.
    """
    if t.device.type != "cuda":
        raise ValueError(f"{name} kernel takes CUDA tensors, got one on {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(
            f"{name} kernel takes {sorted(map(str, dtypes))}, got {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous tensor")
