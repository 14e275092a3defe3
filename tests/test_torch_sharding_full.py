"""The port's parameter and optimizer-state specs of every architecture
at full width (the port's model on the meta device; the reference's
``jax.eval_shape``) against the JAX package's, on the ``(2, 2)``,
``(16, 16)`` and ``(2, 16, 16)`` meshes, ``tp`` on and off, ``moe_ep`` on
and off for the MoE architectures (``tests/port_specs.py``).  A file of
its own: the reference's abstract init of the full models takes most of
its time."""

import pytest

import port_specs as S
import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.configs.ALL import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_param_and_opt_specs_equal_the_reference(arch):
    S.check_param_and_opt_specs(arch, full=True)
