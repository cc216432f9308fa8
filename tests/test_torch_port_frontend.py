"""Front end of the PyTorch port: spec compiler, topology/feature readers,
the golden feature values, and import hygiene.

The port carries the JAX package's host modules (spec, topology, feature);
they must compile exactly the same :class:`CompiledFeatures`. Goldens
(BASELINE.md) hold to 1e-6 abs.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from fixtures import GOLDEN, GOLDEN_REF_X

import molann_tpu.feature as jfeature
import molann_tpu.systems as jsystems
import molann_tpu.topology as jtopology
from molann_tpu.spec import compile_features as jcompile
import molann_tpu_torch.feature as tfeature
import molann_tpu_torch.systems as tsystems
import molann_tpu_torch.topology as ttopology
from molann_tpu_torch.models.ann import AlignmentLayer, FeatureLayer
from molann_tpu_torch.spec import compile_features as tcompile

GOLDEN_ATOL = 1e-6
REPO = Path(__file__).resolve().parents[1]


def _spec_dict(spec):
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("kwargs", [
    {}, {"use_angle_value": True}, {"include_position": False},
])
def test_alanine_spec_matches_jax(kwargs):
    jm, _ = jsystems.alanine_model(**kwargs)
    tm, _ = tsystems.alanine_model(**kwargs)
    js = jm.preprocessing_layer.feature_layer.spec
    ts = tm.preprocessing_layer.feature_layer.spec
    assert _spec_dict(ts) == _spec_dict(js)
    ja = jm.preprocessing_layer.align_layer
    ta = tm.preprocessing_layer.align_layer
    assert ta._local_align_atom_indices == ja._local_align_atom_indices
    np.testing.assert_array_equal(ta.ref_x.numpy(), np.asarray(ja.ref_x))


@pytest.mark.parametrize("section", ["Preprocessing", "Histogram", "Output"])
def test_feature_file_spec_matches_jax(fixture_dir, feature_file, section):
    pdb = str(fixture_dir / "alanine.pdb")
    ju, tu = jtopology.Universe(pdb), ttopology.Universe(pdb)
    jf = jfeature.FeatureFileReader(feature_file, section, ju).read()
    tf = tfeature.FeatureFileReader(feature_file, section, tu).read()
    assert [repr(f) for f in tf] == [repr(f) for f in jf]
    for uav in (False, True):
        assert _spec_dict(tcompile(tf, tu.atoms.ix, uav)) == _spec_dict(
            jcompile(jf, ju.atoms.ix, uav))


def test_selection_and_positions_match_jax(fixture_dir):
    pdb = str(fixture_dir / "alanine.pdb")
    ju, tu = jtopology.Universe(pdb), ttopology.Universe(pdb)
    for sel in ("bynum 1 2 5", "resid 2", "name C* and not resid 1",
                "around 2.0 bynum 9"):
        np.testing.assert_array_equal(tu.select_atoms(sel).ix,
                                      ju.select_atoms(sel).ix)
    np.testing.assert_array_equal(tu.atoms.positions, ju.atoms.positions)


def test_pdb_unit_cell_matches_jax(tmp_path):
    lines = tsystems.alanine_pdb_text().splitlines()
    cryst = "CRYST1   20.000   22.000   25.000  90.00 100.00 110.00 P 1"
    path = tmp_path / "boxed.pdb"
    path.write_text("\n".join([lines[0], cryst, *lines[1:]]) + "\n")
    tbox = ttopology.Universe(str(path)).box
    jbox = jtopology.Universe(str(path)).box
    assert tbox is not None
    np.testing.assert_array_equal(np.asarray(tbox), np.asarray(jbox))


@pytest.mark.parametrize("use_angle_value", [False, True])
def test_goldens_through_feature_layer(fixture_dir, feature_file,
                                       use_angle_value):
    u = ttopology.Universe(str(fixture_dir / "alanine.pdb"))
    feats = tfeature.FeatureFileReader(feature_file, "Histogram", u).read()
    layer = FeatureLayer(feats, u.atoms, use_angle_value)
    x = torch.as_tensor(u.atoms.positions[None])
    got = layer(x).numpy()[0]
    want = []
    for f in feats:
        v = GOLDEN[f.get_name()][1 if use_angle_value else 0]
        want.extend(np.atleast_1d(v).tolist())
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=GOLDEN_ATOL)


def test_alignment_reference_golden():
    u = tsystems.alanine_universe()
    align = AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms)
    np.testing.assert_allclose(align.ref_x.numpy(), GOLDEN_REF_X,
                               atol=GOLDEN_ATOL)
    aligned = align(torch.as_tensor(u.atoms.positions[None]))
    np.testing.assert_allclose(aligned[0, [0, 1, 4]].numpy(), GOLDEN_REF_X,
                               atol=1e-5)


def test_feature_info_imports_pandas_lazily():
    u = tsystems.alanine_universe()
    info = tfeature.Feature("b1", "bond", u.select_atoms("bynum 2 5")
                            ).get_feature_info()
    assert list(info["name"]) == ["b1"]


def test_feature_docstring_examples():
    import doctest

    res = doctest.testmod(tfeature, verbose=False)
    assert res.failed == 0 and res.attempted >= 15


def test_import_needs_no_jax_or_pandas():
    code = ("import sys, molann_tpu_torch, molann_tpu_torch.serve, "
            "molann_tpu_torch.io, molann_tpu_torch.systems, "
            "molann_tpu_torch.train, molann_tpu_torch.ops._build; "
            "bad = [m for m in ('jax', 'pandas', 'molann_tpu') "
            "if m in sys.modules]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    pkg = REPO / "molann_tpu_torch"
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from molann_tpu." not in text and "import molann_tpu\n" \
            not in text, path
