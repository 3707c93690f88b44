"""``int_fold``'s CUDA kernel against its plain version, on the card.

Skips where there is no CUDA card (the CPU runs the plain version only:
``tests/test_torch_int_fold.py``).  Bit for bit, two runs equal: shared
rows (K = 768, the counts of K = 100), global atomics (K = 2^16 zipf, a
hot key), D = 0, 1 and 3, int32 and int64 rows.  ``chip_smoke.py``'s
phase 2 (``check_int_fold``) runs the full set of cases.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int_fold import int_fold_plain  # noqa: E402

CASES = [  # (n, D, K, row dtype, zipf keys)
    (1 << 22, 1, 1 << 16, np.int32, True),
    (1 << 20, 1, 768, np.int32, False),
    (1 << 20, 0, 100, np.int32, False),
    (100_003, 3, 100, np.int64, True),
    (31, 1, 4, np.int32, False),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"n{c[0]}-d{c[1]}-k{c[2]}")
def test_kernel_equals_plain_bit_for_bit(card, case):
    n, d, k, dt, zipf = case
    rng = np.random.default_rng(0)
    keys = ((rng.zipf(1.2, n) % k) if zipf
            else rng.integers(0, k, n)).astype(np.int32)
    keys[rng.random(n) < 0.1] = k  # the sentinel never lands
    rows = rng.integers(-2**31, 2**31, (n, d)).astype(dt)
    table = rng.integers(-2**40, 2**40, (k, d)).astype(np.int64)
    counts = rng.integers(0, 1000, k).astype(np.int32)
    host = [torch.from_numpy(a) for a in (keys, rows, table, counts)]
    dev = [t.to(card) for t in host]
    got = [ops.int_fold(*dev) for _ in range(2)]
    want = int_fold_plain(*host)
    for a, b, w in zip(got[0], got[1], want):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), w)
