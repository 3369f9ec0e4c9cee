import time

_T_START = time.perf_counter()

import sys  # noqa: E402

from wsbench.run import main  # noqa: E402

sys.exit(main(_T_START))
