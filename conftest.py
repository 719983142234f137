"""Keep each pytest process under the kernel's limit on memory mappings.

Every program XLA:CPU compiles stays loaded, and each maps its own code and
data pages, so a process that compiles many large programs (the
interpret-mode Pallas kernels of ``tests/test_cascaded_pallas.py`` alone
take about 65 000 mappings) reaches ``vm.max_map_count`` (65 530 by
default).  The next compilation's ``mmap`` then fails and XLA aborts or
segfaults inside ``backend_compile_and_load``.  After a test that leaves the
process above half the limit, this drops JAX's caches of compiled programs,
which unmaps them; later tests compile again what they need.

JAX is never imported here: ``tests/conftest.py`` sets its flags before the
first import, and a process that never imported it has nothing to drop.
"""

import gc
import sys

_MAPS = "/proc/self/maps"
_LIMIT = "/proc/sys/vm/max_map_count"


def _count_lines(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f)


def _map_limit() -> int | None:
    try:
        with open(_LIMIT) as f:
            return int(f.read())
    except (OSError, ValueError):
        return None  # not Linux: no limit to keep under


_limit = _map_limit()


def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is None or _limit is None or _count_lines(_MAPS) <= _limit // 2:
        return
    jax.clear_caches()
    gc.collect()
