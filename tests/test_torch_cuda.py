"""Card-only tests: the port's CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips on a host without a CUDA device
(the fixture decides at run time, so every pytest worker collects the same
tests).  This file imports no JAX, so it also runs on a machine that has
PyTorch and the CUDA toolkit but no JAX; there, skip the JAX-importing
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-4 / atol 1e-4 - the kernels sum the same fp32 terms as
the plain versions in another order (register FMAs against tensor ops).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.types import DFRConfig, Nonlinearity
from repro_torch.kernels import ops
from repro_torch.kernels import streaming as k_streaming
from repro_torch.kernels import train as k_train
from repro_torch.runtime import StreamRequest, StreamServer

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(dev, n_sys, b, t, nx, ny, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, t + 1, (n_sys, b))
    lengths.flat[:2] = (1, t)
    arrays = (
        rng.normal(size=(n_sys, b, t, nx)).astype(np.float32),
        lengths.astype(np.int32),
        rng.uniform(0.01, 0.6, n_sys).astype(np.float32),
        rng.uniform(-0.6, 0.6, n_sys).astype(np.float32),
        (0.05 * rng.normal(size=(n_sys, ny, nx * (nx + 1)))).astype(
            np.float32),
        rng.normal(size=(n_sys, ny)).astype(np.float32),
    )
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


SHAPES = [(1, 3, 7, 1, 2), (3, 4, 20, 5, 3), (2, 8, 93, 30, 10),
          (4, 2, 33, 32, 4)]


@pytest.mark.parametrize("n_sys,b,t,nx,ny", SHAPES)
@pytest.mark.parametrize("f_name", ["linear", "tanh", "mackey_glass"])
def test_k1_kernel_matches_plain(dev, n_sys, b, t, nx, ny, f_name):
    j, lens, p, q, _, _ = _operands(dev, n_sys, b, t, nx, ny, seed=nx + t)
    f = Nonlinearity(f_name, 0.8)
    got = ops.train_forward(j, lens, p, q, f, backend="cuda")
    want = ops.train_forward(j, lens, p, q, f, backend="torch")
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("r", "x_last", "x_prev", "j_last")):
        torch.testing.assert_close(g, w, msg=name, **TOL)


@pytest.mark.parametrize("n_sys,b,t,nx,ny", SHAPES)
@pytest.mark.parametrize("f_name", ["linear", "tanh", "mackey_glass"])
def test_k2_kernel_matches_plain(dev, n_sys, b, t, nx, ny, f_name):
    j, lens, p, q, W, bias = _operands(dev, n_sys, b, t, nx, ny, seed=t)
    f = Nonlinearity(f_name, 0.8)
    got = ops.streaming_logits_slots(j, lens, p, q, W, bias, f,
                                     backend="cuda")
    want = ops.streaming_logits_slots(j, lens, p, q, W, bias, f,
                                      backend="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


def test_launch_counts_and_default_dispatch(dev):
    j, lens, p, q, W, bias = _operands(dev, 2, 3, 9, 6, 3, seed=0)
    k1, k2 = k_train.KERNEL.launches, k_streaming.KERNEL.launches
    ops.train_forward(j, lens, p, q)                  # backend from device
    ops.streaming_logits_slots(j, lens, p, q, W, bias)
    ops.train_forward(j, lens, p, q, backend="torch")  # the plain version
    assert k_train.KERNEL.launches == k1 + 1
    assert k_streaming.KERNEL.launches == k2 + 1


def test_kernels_reject_what_they_do_not_take(dev):
    j, lens, p, q, W, bias = _operands(dev, 1, 2, 5, 33, 2, seed=1)
    with pytest.raises(ValueError, match="Nx"):
        ops.train_forward(j, lens, p, q)
    j, lens, p, q, W, bias = _operands(dev, 1, 2, 5, 4, 2, seed=1)
    with pytest.raises(ValueError, match="device|on"):
        k_train.train_forward_cuda(j[0], lens[0], p.cpu(), q)
    with pytest.raises(TypeError):
        k_train.train_forward_cuda(j[0], lens[0].float(), p, q)
    with pytest.raises(ValueError, match="contiguous"):
        k_train.train_forward_cuda(j[0].transpose(0, 1), lens[0], p, q)


def test_server_on_card_agrees_with_cpu(dev):
    """A small episode through K1 and K2 on the card against the same
    episode on the CPU; each kernel launches once per server round."""
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
    rng = np.random.default_rng(0)
    mask = np.sign(rng.normal(size=(8, 2))).astype(np.float32)
    results = {}
    for device in ("cuda", "cpu"):
        srv = StreamServer(cfg, t_max=16, max_streams=3, window=2,
                           phase_steps=2, refresh_every=3, mask=mask,
                           device=device)
        for rid, n in enumerate((8, 6, 10, 4, 7)):
            r = np.random.default_rng(rid)
            srv.submit(StreamRequest(
                rid=rid, u=r.normal(size=(n, 16, 2)).astype(np.float32),
                length=r.integers(4, 17, n).astype(np.int32),
                label=r.integers(0, 3, n).astype(np.int32)))
        k1, k2 = k_train.KERNEL.launches, k_streaming.KERNEL.launches
        done = srv.run_until_drained()
        if device == "cuda":
            assert k_train.KERNEL.launches - k1 == srv.global_step
            assert k_streaming.KERNEL.launches - k2 == srv.global_step
        results[device] = {r.rid: r.preds for r in done}
    total = sum(len(v) for v in results["cpu"].values())
    agree = sum(int(a == b) for rid, v in results["cpu"].items()
                for a, b in zip(v, results["cuda"][rid]))
    assert agree / total >= 0.98
