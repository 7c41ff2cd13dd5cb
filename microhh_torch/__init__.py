"""microhh_torch: the PyTorch/CUDA port of microhh_tpu for one NVIDIA H100.

The package imports torch and never jax.  Its host modules (config, grid,
fields, timeloop, utils/nc) are numpy copies of microhh_tpu's; its step runs
hand-written CUDA kernels (csrc/, built at first use by kernels.py) on a
CUDA device and their plain-torch versions on the CPU.
"""

__version__ = "0.1.0"

from .config import Ini
from .grid import Grid
from .fields import Fields
from .timeloop import Timeloop
from .model import Model, run_case
