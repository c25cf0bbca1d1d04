"""One CPU thread for PyTorch in the test processes.

The fast tier runs six pytest-xdist workers on an eight-core machine.
PyTorch's default intra-op pool has one thread per core, so six workers
oversubscribe the cores and its OpenMP threads wait on each other: the
plain versions' small tensor operations ran up to 70 times slower than
on one thread (the classic Cartesian rhs of ``test_torch_swe_cartesian``
at C48), and the port's fast-tier files took twice their single-thread
time in all.  Every port test module imports this module, and every
worker collects them all, so each worker's PyTorch runs on one thread.
The tests' tensors are small (C8-C48), where the pool buys nothing.
"""

import torch

torch.set_num_threads(1)
