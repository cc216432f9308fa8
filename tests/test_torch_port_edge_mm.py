"""The edge-product probe's plain versions, on the CPU.

``molann_tpu_torch.probes.edge_mm_probe.edge_mm`` computes ``D [M, K] @ x
[K, N]`` (D 0/±1) in seven bodies; on the CPU it runs ``edge_mm_plain``,
the plain PyTorch version of each body's arithmetic. Each is held against
float64 numpy within the error its scheme allows, as a fraction of
``max|truth|`` (the measure of scripts/int8_mm_probe.py:196-207):

- ``f32``, ``gather``, ``split3``, ``fixed4``: a few f32 roundings, 3e-7;
- ``bf16``: one bf16 rounding of x, 2^-9 of |x| ≤ 30 per term: 4e-3;
- ``fixed2``: x to the nearest 2^-9 Å, at most 2^-10 off per term and
  a dozen terms a row: 2e-4;
- ``int8``: the timing unit of the TPU probe; it multiplies
  ``clip(round(x / 256))`` and is exact in that, so it is held to its own
  definition.

``split3`` is also held against the JAX package's ``_split3_mm``
(molann_tpu/ops/fused_blocked.py:112) on the same D and x.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.ops.fused_blocked import _split3_mm
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.probes import edge_mm_probe as EP

TOL = {"f32": 3e-7, "gather": 3e-7, "split3": 3e-7, "fixed4": 3e-7,
       "bf16": 4e-3, "fixed2": 2e-4}


@pytest.fixture(scope="module")
def inputs():
    D, x = EP.probe_inputs(T=8, seed=0, tiles=4)
    truth = D.astype(np.float64) @ x.astype(np.float64)
    return D, x, truth


def test_probe_inputs_are_the_probes_shapes(inputs):
    D, x, _ = inputs
    assert D.shape == (552, 304) and x.shape == (304, 32)
    assert D.dtype == np.float32 and x.dtype == np.float32
    assert set(np.unique(D)) == {-1.0, 0.0, 1.0}
    assert 0.005 < np.mean(D != 0) < 0.015 and np.abs(x).max() <= 30.0
    D2, x2 = EP.probe_inputs(T=8, seed=0, tiles=4)
    np.testing.assert_array_equal(D, D2)
    np.testing.assert_array_equal(x, x2)
    assert EP.probe_inputs(512)[1].shape == (304, 64 * 512)


@pytest.mark.parametrize("variant", sorted(TOL))
def test_plain_against_float64(inputs, variant):
    D, x, truth = inputs
    got = EP.edge_mm(torch.from_numpy(D), torch.from_numpy(x), variant)
    assert got.dtype == torch.float32 and got.shape == truth.shape
    err = np.abs(got.numpy() - truth).max() / np.abs(truth).max()
    assert err <= TOL[variant]
    if variant in ("bf16", "fixed2"):  # a reduced form really is reduced
        assert err > 1e-6


def test_int8_pass_is_exact_in_its_own_terms(inputs):
    D, x, _ = inputs
    x = x * 100.0  # past 128, where x / 256 rounds to something
    q = np.clip(np.round(x.astype(np.float64) / 256.0), -127, 127)
    got = EP.edge_mm(torch.from_numpy(D), torch.from_numpy(x), "int8")
    assert np.abs(q).max() >= 10
    np.testing.assert_array_equal(got.numpy(), D.astype(np.float64) @ q)


def test_split3_matches_the_jax_package(inputs):
    D, x, truth = inputs
    ref = np.asarray(_split3_mm(jnp.asarray(D, dtype=jnp.bfloat16),
                                jnp.asarray(x)))
    got = EP.edge_mm_plain(torch.from_numpy(D), torch.from_numpy(x), "split3")
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=2e-7 * np.abs(truth).max())


def test_fixed_point_digits_recombine():
    xi = torch.tensor([0, 1, -1, 127, 128, -128, -129, 30 * 2 ** 19,
                       -30 * 2 ** 19, 2 ** 24 + 3], dtype=torch.int32)
    for count in (4, 2):
        digits = EP._signed_digits(xi, count)
        assert all(int(d.min()) >= -128 and int(d.max()) <= 127
                   for d in digits)
        if count == 4:
            back = sum(d.to(torch.int64) * 256 ** k
                       for k, d in enumerate(digits))
            assert torch.equal(back, xi.to(torch.int64))


def test_gather_table(inputs):
    D, x, _ = inputs
    row_ptr, ent = EP.gather_table(D)
    assert row_ptr.dtype == np.int32 and ent.dtype == np.int32
    assert row_ptr[0] == 0 and row_ptr[-1] == len(ent) == int((D != 0).sum())
    out = np.zeros((D.shape[0], x.shape[1]), np.float64)
    for m in range(D.shape[0]):
        for e in ent[row_ptr[m]:row_ptr[m + 1]]:
            out[m] += np.sign(e) * x[abs(e) - 1]
    np.testing.assert_allclose(out, D.astype(np.float64) @ x, atol=1e-9)
    with pytest.raises(ValueError, match="0 and ±1"):
        EP.gather_table(D * 0.5)


def test_errors_and_counters(inputs):
    D, x, _ = inputs
    Dt, xt = torch.from_numpy(D), torch.from_numpy(x)
    with pytest.raises(ValueError, match="variant"):
        EP.edge_mm(Dt, xt, "fp8")
    with pytest.raises(ValueError, match="variant"):
        EP.edge_mm_plain(Dt, xt, "fp8")
    with pytest.raises(ValueError, match="expected D"):
        EP.edge_mm(Dt, xt[:-1], "f32")
    assert F.KERNEL_LAUNCHES["edge_mm"] == 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        EP.run_probe(8, 1)
    res = EP.run_probe(8, 1, device="cpu")
    assert set(res) == set(EP.VARIANTS) | {"library"}
    assert all(res[v]["rel_err"] <= TOL.get(v, 1.0) for v in EP.VARIANTS)
