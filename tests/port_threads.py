"""One CPU thread for torch in the port's tests (imported by each
``tests/test_torch_*.py`` for this side effect).

The tier-1 run puts six pytest-xdist workers on the machine's cores, and
torch's intra-op pool takes every core in each of them: the small tensor
ops of these tests then wait on threads that other workers keep busy.  A
case of ``test_torch_flash16_stacked.py`` that takes 0.44 s with one
thread took 10.7 s with the default pool beside six busy processes on an
8-core machine.  One thread a worker keeps each case at its own time.
"""

import torch

torch.set_num_threads(1)
