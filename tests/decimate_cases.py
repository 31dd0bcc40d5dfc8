"""The fold's test cases (raw_ngp_torch.kernels.compact.decimate_compact),
shared by its CPU parity tests against JAX (tests/test_torch_decimate.py)
and its card tests (tests/test_torch_kernels.py). numpy only.
"""

import numpy as np

DECIMATE_CASES = ("stride1", "stride2", "stride3", "backstop", "empty",
                  "full", "all_miss")


def decimate_case(name, N, K, seed=0):
    """Seeded inputs of the fold (numpy): mask [N, K], miss [N], ts [N, K]
    (-1 where dead), dt [N, 1] and the slot budget m_pad that gives the
    case: stride 1, 2 or 3; the tail backstop (stride 2, every ray an odd
    count, so the per-ray rounding up overflows the budget and slots past
    m_pad drop mid-ray); an empty mask; a full one (stride ceil(N K /
    m_pad)); every ray a miss."""
    rng = np.random.default_rng(seed)
    mask = rng.random((N, K)) < 0.4
    miss = rng.random(N) < 0.1
    if name == "empty":
        mask[:] = False
    elif name == "full":
        mask[:], miss[:] = True, False
    elif name == "all_miss":
        miss[:] = True
    elif name == "backstop":
        mask[:], miss[:] = False, False
        n = 2 * rng.integers(0, K // 2, N) + 1
        order = np.argsort(rng.random((N, K)), axis=1)
        mask[np.arange(N)[:, None], order] = np.arange(K)[None] < n[:, None]
    live = int((mask & ~miss[:, None]).sum())
    m_pad = {"stride1": live + 37, "stride2": int(live / 1.6),
             "stride3": int(live / 2.5), "backstop": (live + 1) // 2 + 1,
             "empty": 128, "full": 256, "all_miss": 128}[name]
    ts = np.where(mask, rng.random((N, K)) * 3 + 0.5, -1.0).astype(np.float32)
    dt = (rng.random((N, 1)) * 0.1 + 1e-3).astype(np.float32)
    return mask, miss, ts, dt, m_pad
