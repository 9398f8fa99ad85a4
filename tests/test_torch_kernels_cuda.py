"""The per-action CUDA kernel against its plain version, on the card.

Marked ``cuda``: without a GPU every test here skips (the kernel has no
CPU or interpret mode).  On a machine with an H100 and ``nvcc``:
``python -m pytest tests/test_torch_kernels_cuda.py -q``."""

import numpy as np
import pytest
import torch

from dcarl_tpu_torch import disable_tf32
from dcarl_tpu_torch.config import DRIVING_HALF_WIDTHS
from dcarl_tpu_torch.ops import _cuda
from dcarl_tpu_torch.ops import store_kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    disable_tf32()
    return torch.device("cuda")


def _store(rng, n, b, dup=1, off_lattice=0):
    d, A = 21, 11
    centers = rng.normal(0, 4, (32, d - 1)).astype(np.float32)
    keys = np.zeros((n, d), np.float32)
    keys[:, :-1] = centers[rng.integers(0, 32, n)] + rng.normal(0, 1.0, (n, d - 1))
    keys[:, -1] = rng.integers(0, A, n)
    keys[:off_lattice, -1] = 4.5
    keys = np.repeat(keys[: n // dup], dup, axis=0)[:n]
    values = rng.normal(0, 1, len(keys)).astype(np.float32)
    valid = rng.random(len(keys)) < 0.9
    # queries next to valid rows, so that every query matches something
    near = np.flatnonzero(valid)[rng.permutation(int(valid.sum()))[:b]]
    obs = (keys[near, :-1] + rng.normal(0, 0.1, (b, d - 1))).astype(np.float32)
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32)
    return keys, values, valid, obs, w


@pytest.mark.parametrize("n,b,dup,off", [(5000, 300, 1, 100),
                                         (20000, 1000, 50, 0),
                                         (3000, 1, 1, 0)])
def test_kernel_matches_plain(cuda, n, b, dup, off):
    keys, values, valid, obs, w = _store(np.random.default_rng(n), n, b, dup,
                                         off)
    t = [torch.as_tensor(a, device=cuda) for a in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    before = _cuda.LAUNCHES["peraction_moments"]
    got = K.query_peraction_prepared(prep, q)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["peraction_moments"] == before + 1
    ref = K.peraction_moments_plain(prep, q)
    assert ref[..., 0].sum() > 0
    torch.testing.assert_close(got[..., 0], ref[..., 0], rtol=0, atol=0)
    torch.testing.assert_close(got[..., 1:], ref[..., 1:], rtol=1e-4, atol=1e-3)


def test_kernel_rejects_bad_operands(cuda):
    keys, values, valid, obs, w = _store(np.random.default_rng(0), 1000, 10)
    t = [torch.as_tensor(a, device=cuda) for a in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    with pytest.raises(TypeError):
        K.query_peraction_prepared(prep, q.half())
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep, q[:, :10])
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep, q.T.contiguous().T)
    small = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11,
                                      n_tile=128)
    with pytest.raises(ValueError):
        K.query_peraction_prepared(small, q)
