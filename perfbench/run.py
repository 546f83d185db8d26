"""Run one cell of the port's benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cells.  Exits
2 without a CUDA card.  The program's kernels build into ``build/`` of the
checkout on the first run there; the kernel caches torch and Triton would
use are kept in ``build/perfbench/`` too.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one host thread for torch's and the BLAS libraries' pools: the card's
# work is dispatched from the one Python thread, and idle pools only take
# cores from it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# the package's own directory off the path: its modules are imported as
# perfbench.*, from the checkout's root
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
