"""One intra-op thread for torch in the port's CPU tests (no tests here).

Every other ``test_torch_*.py`` imports this module first.  The suite runs
under pytest-xdist with several workers, and each worker's torch would
otherwise start as many intra-op threads as the machine has cores, beside
the XLA threads of the JAX package's long-running files on the other
workers; the port's tests work at smoke sizes, where one thread is as
fast.  Importing sets it for the whole worker process (xdist workers
import every test file, so every worker holds the cap)."""
import torch

torch.set_num_threads(1)
