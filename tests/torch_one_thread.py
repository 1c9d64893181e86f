"""Importing this module sets torch to one intra-op thread for the process.

The port's parity tests that import it work on a few thousand lanes, where
intra-op threads gain nothing.  The setting is process-wide, and every
pytest-xdist worker imports every test file, so all port tests of a worker
then run on one torch thread.  That is the point: several workers with a
full set of spinning OpenMP threads each oversubscribe the host's cores (a
32^2 port render that takes 3 s alone was seen to take over 10 minutes with
four 8-thread processes side by side).
"""

import torch

torch.set_num_threads(1)
