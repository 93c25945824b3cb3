"""The port's EC variant tuner and its probe against the JAX package's
contract (``ceph_tpu/ec/kernel.py`` set_fused_config,
_resolve_fused_config, autotune, _pallas_probe_sum).

On the CPU every variant runs the kernel's plain version, so these tests
hold the selection semantics (global against shape-bound, bases taken
from the globals, later calls seeing later changes), the tuner's install
and fallback rules, and the probe's wrapped int32 sum against the
reference's ``_apply_bitmatrix`` output.  Tolerance 0: sums and configs
are integers.
"""

import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import devstats
from ceph_tpu_torch.ec import gf256, kernel

GEN = gf256.rs_vandermonde_matrix(8, 4)


@pytest.fixture(autouse=True)
def fresh_config(monkeypatch):
    """Each test starts from the champion default and leaves the
    process-wide config as it found it."""
    monkeypatch.setattr(kernel, "_EC_SHAPE_CFG", {})
    for name, v in zip(("_EC_THREADS", "_EC_LANES", "_EC_ROWS"),
                       kernel.TUNE_SPACE[0]):
        monkeypatch.setattr(kernel, name, v)


def test_tune_space_starts_with_the_champion():
    assert kernel.TUNE_SPACE[0] == (128, 16, 4)
    assert len(set(kernel.TUNE_SPACE)) == len(kernel.TUNE_SPACE) >= 4
    assert kernel._resolve_fused_config((4, 8)) == (128, 16, 4)


def test_global_config_reaches_every_shape():
    got = kernel.set_fused_config(threads=256)
    assert got == {"threads": 256, "lanes": 16, "rows": 4}
    assert kernel._resolve_fused_config((4, 8)) == (256, 16, 4)
    assert kernel._resolve_fused_config((2, 8)) == (256, 16, 4)


def test_shape_config_binds_one_shape_with_global_bases():
    kernel.set_fused_config(threads=256)              # global: (256, 16, 4)
    got = kernel.set_fused_config(rows=8, shape=(2, 8))
    assert got == {"threads": 256, "lanes": 16, "rows": 8, "shape": (2, 8)}
    assert kernel._resolve_fused_config((2, 8)) == (256, 16, 8)
    assert kernel._resolve_fused_config((4, 8)) == (256, 16, 4)
    # a later shape-bound change takes its bases from the bound entry
    kernel.set_fused_config(threads=128, shape=(2, 8))
    assert kernel._resolve_fused_config((2, 8)) == (128, 16, 8)
    # a later global change leaves the bound shape alone
    kernel.set_fused_config(threads=512, rows=4)
    assert kernel._resolve_fused_config((4, 8)) == (512, 16, 4)
    assert kernel._resolve_fused_config((2, 8)) == (128, 16, 8)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="not in TUNE_SPACE"):
        kernel.set_fused_config(threads=32)
    ops = kernel.from_reference_matrix(GEN[8:], "cpu")
    data = torch.zeros((8, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not in TUNE_SPACE"):
        kernel.gf_apply(ops, data, config=(512, 16, 8))
    with pytest.raises(ValueError, match="not in TUNE_SPACE"):
        kernel.gf_apply_checksum(ops, data, config=(256, 8, 8))


def test_launches_resolve_the_config_at_each_call():
    devstats.reset()
    ap = kernel.MatrixApply(GEN[8:], "cpu")
    data = torch.zeros((8, 128), dtype=torch.uint8)
    ap.device_call(data)
    kernel.set_fused_config(threads=256)
    ap.device_call(data)
    kernel.set_fused_config(threads=64, rows=4, shape=(4, 8))
    ap.device_call(data)
    c = devstats.counters()
    assert c["launches"]["ec_apply"] == 3
    assert c["compiles"]["ec_apply"] == 3      # three resolved configs
    ap.device_call(data)
    assert devstats.counters()["compiles"]["ec_apply"] == 3


@pytest.mark.parametrize("install", ["global", "shape"])
def test_autotune_installs_per_install(install):
    dec = gf256.decode_matrix(GEN, [1, 2, 4, 5, 6, 7, 8, 9], [0, 3])
    got = kernel.autotune(dec, length=1 << 15, trials=2, install=install,
                          device="cpu")
    cfg = (got["threads"], got["lanes"], got["rows"])
    assert cfg in kernel.TUNE_SPACE
    assert got["rate_mb_s"] is None or got["rate_mb_s"] > 0
    assert kernel._resolve_fused_config((2, 8)) == cfg
    if install == "shape":
        assert got["shape"] == (2, 8)
        assert kernel._EC_SHAPE_CFG == {(2, 8): cfg}
        assert kernel._resolve_fused_config((4, 8)) == kernel.TUNE_SPACE[0]
    else:
        assert "shape" not in got and kernel._EC_SHAPE_CFG == {}
        assert kernel._resolve_fused_config((4, 8)) == cfg


def test_autotune_picks_the_best_slope(monkeypatch):
    # fake clock: variant i costs (i + 1) per byte, so TUNE_SPACE[0] wins
    def probe(ops, data, cfg):
        return (kernel.TUNE_SPACE.index(cfg) + 1) * data.numel() * 1e-9
    monkeypatch.setattr(kernel, "_probe_seconds", probe)
    got = kernel.autotune(GEN[8:], length=1 << 14, trials=1, device="cpu")
    assert (got["threads"], got["lanes"], got["rows"]) == \
        kernel.TUNE_SPACE[0]
    assert got["rate_mb_s"] == pytest.approx(1000.0, rel=1e-3)


def test_autotune_slope_noise_fallback(monkeypatch):
    kernel.set_fused_config(threads=256)
    monkeypatch.setattr(kernel, "_probe_seconds",
                        lambda ops, data, cfg: 1.0 / data.numel())
    got = kernel.autotune(GEN[8:], length=1 << 14, trials=1, device="cpu")
    assert got == {"threads": 128, "lanes": 16, "rows": 4,
                   "rate_mb_s": None, "note": "slope-noise fallback"}
    assert kernel._resolve_fused_config((4, 8)) == kernel.TUNE_SPACE[0]
    got = kernel.autotune(GEN[8:], length=1 << 14, trials=1,
                          install="shape", device="cpu")
    assert got["shape"] == (4, 8) and got["note"] == "slope-noise fallback"


def test_autotune_budget_stops_between_variants(monkeypatch):
    """A variant starts only while the worst variant cost so far still
    fits: each probe here takes 0.1 s, a variant two of them, so with a
    0.19 s budget the first variant runs and the second never starts."""
    calls = []

    def probe(ops, data, cfg):
        calls.append(cfg)
        time.sleep(0.1)
        return data.numel() * 1e-9
    monkeypatch.setattr(kernel, "_probe_seconds", probe)
    got = kernel.autotune(GEN[8:], length=1 << 14, trials=1, budget_s=0.19,
                          device="cpu")
    assert set(calls) == {kernel.TUNE_SPACE[0]}
    assert got["rate_mb_s"] is not None


def test_autotune_does_not_swallow_probe_errors(monkeypatch):
    def broken(ops, data, config=None):
        raise RuntimeError("gf_apply_checksum launch failed: CUDA error 1")
    monkeypatch.setattr(kernel, "gf_apply_checksum", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.autotune(GEN[8:], length=1 << 14, trials=1, device="cpu")
    assert kernel._resolve_fused_config((4, 8)) == kernel.TUNE_SPACE[0]


def test_autotune_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.autotune(GEN[8:], length=1 << 14)


def test_probe_sum_small_matches_reference():
    import jax.numpy as jnp
    from ceph_tpu.ec.kernel import _apply_bitmatrix
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (8, 5000), dtype=np.uint8)
    ops = kernel.from_reference_matrix(GEN[8:], "cpu")
    got = kernel.gf_apply_checksum(ops, torch.from_numpy(data))
    assert got.dtype == torch.int32 and got.dim() == 0
    ref = _apply_bitmatrix(jnp.asarray(gf256.expand_to_bitmatrix(GEN[8:]),
                                       jnp.int8), jnp.asarray(data))
    assert int(got) == int(ref.astype(jnp.int32).sum())


def test_probe_sum_wraps_like_the_reference():
    """Four unit rows copy 2.2 Mi bytes >= 0xF0 per row: the int32 sum of
    the 8.8 Mi output bytes passes 2^31 and wraps negative, in the
    reference's XLA int32 sum and in the port's plain probe alike."""
    import jax.numpy as jnp
    from ceph_tpu.ec.kernel import _apply_bitmatrix
    rng = np.random.default_rng(11)
    mat = np.eye(4, dtype=np.uint8)
    data = rng.integers(0xF0, 0x100, (4, 2_200_003), dtype=np.uint8)
    exact = int(data.astype(np.int64).sum())
    assert exact > 2**31
    ref = _apply_bitmatrix(jnp.asarray(gf256.expand_to_bitmatrix(mat),
                                       jnp.int8), jnp.asarray(data))
    ref_sum = int(ref.astype(jnp.int32).sum())
    del ref
    ops = kernel.from_reference_matrix(mat, "cpu")
    got = int(kernel.gf_apply_checksum(ops, torch.from_numpy(data)))
    assert got == ref_sum == (exact + 2**31) % 2**32 - 2**31 < 0
