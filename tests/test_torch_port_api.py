"""The port's public API against the reference's.

For every module of ``molann_tpu_torch`` that has a counterpart in
``molann_tpu`` (same dotted path), the names of ``__all__`` and the
signature of each public callable are held to the reference's. Parameters
are compared by name, kind and order, and defaults where the reference's
default is a plain Python value (a JAX object such as ``jnp.tanh`` or
``Precision.HIGHEST`` has no counterpart to compare with). Every difference
must be on the written lists below, each with its reason; a difference
that is not, or an entry that no longer differs, fails the test.
"""

import importlib
import inspect
import pkgutil

import pytest

import molann_tpu_torch

# reasons, by the difference's kind
DEVICE = ("device=: the port's entry points run on the card unless the "
          "caller asks for the CPU")
GENERATOR = ("key -> generator: a torch.Generator in place of a JAX PRNG key "
             "(the two give different numbers from one seed)")
ACTIVATION = ("activations by name: the port's layers and kernels take the "
              "names io.serialize writes, not JAX callables")
MODULE = ("nn.Module layers: the MLP is a torch.nn.Module of nn.Linear "
          "layers, not a pytree of parameter arrays")
OPTIMIZER = ("the optimizer outside the step: a step takes and returns the "
             "torch.optim.Optimizer where JAX threads opt_state "
             "(make_train_step(loss_fn, mesh))")
DONATE = "donate: JAX buffer donation has no counterpart in PyTorch"
AUTO_TILE = ("auto_tile: sizes VMEM tiles of the TPU kernels; the CUDA "
             "kernels choose their own tile")
STABLEHLO = ("StableHLO artifacts: replaced by design by the TorchScript "
             "engine artifact (io.export.export_artifact/load_artifact), "
             "which LibTorch loads; raw_mlir, the bare StableHLO framing for "
             "a PJRT runtime, has no counterpart")
BUNDLE = ("export_bundle/read_bundle: replaced by design; a bundle of "
          "fixed-batch modules exists because a bare PJRT runtime cannot "
          "refine a polymorphic batch, and a TorchScript artifact takes any "
          "batch; the bundle's c_mat section is a buffer of the artifact")
ARTIFACT = ("the TorchScript engine artifact (fused: K1/K4/K6/K8 as torch "
            "custom ops) in place of StableHLO")
TABLES = ("artifact_tables: the tables an engine artifact carries for the "
          "fused kernels, as tensors and ints")
PYTREE = ("utils.pytree: JAX pytree registration, removed, not ported "
          "(ROADMAP.md queue 2, 'Removed')")
BACKEND = ("backend=: the torch.distributed backend, NCCL across cards and "
           "gloo on the host or for several ranks sharing one card (JAX forms "
           "its own runtime)")
MESH_ARG = ("axis= -> mesh=: JAX names the mesh axis inside shard_map; the "
            "port's collectives run over the mesh's process group, so the "
            "mesh is passed")
PLAIN = ("the port's additions: each kernel's plain PyTorch version, the "
         "launch counts and helpers the CPU tests and chip_smoke.py use")

# (module, name) the reference exports and the port does not
MISSING = {
    **{(mod, n): (BUNDLE if "bundle" in n else STABLEHLO)
       for mod in ("molann_tpu_torch.io", "molann_tpu_torch.io.export")
       for n in ("export_bundle", "export_stablehlo", "load_stablehlo",
                 "read_bundle")},
    ("molann_tpu_torch.ops.fused_blocked", "auto_tile"): AUTO_TILE,
    ("molann_tpu_torch.utils", "PytreeNode"): PYTREE,
    ("molann_tpu_torch.utils", "register_model"): PYTREE,
}

# (module, name) the port exports and the reference does not
EXTRA = {
    ("molann_tpu_torch.io", "model_from_arrays"): (
        "model_from_arrays: builds a model from the .npz arrays already in "
        "memory (the checkpoint reader's path)"),
    ("molann_tpu_torch.io.serialize", "model_from_arrays"): (
        "model_from_arrays, as above"),
    ("molann_tpu_torch.io.serialize", "FORMAT_VERSION"): (
        "FORMAT_VERSION: the .npz format the port reads and writes"),
    ("molann_tpu_torch.models", "ACTIVATIONS"): ACTIVATION,
    ("molann_tpu_torch.models", "model_dims"): PLAIN,
    ("molann_tpu_torch.models", "named_tensors"): (
        "named_tensors: a model's parameters and buffers by name, the "
        "leaves a JAX pytree holds"),
    ("molann_tpu_torch.models.ann", "ACTIVATIONS"): ACTIVATION,
    ("molann_tpu_torch.models.ann", "named_tensors"): (
        "named_tensors, as above"),
    **{(mod, n): ARTIFACT
       for mod in ("molann_tpu_torch.io", "molann_tpu_torch.io.export")
       for n in ("export_artifact", "load_artifact")},
    ("molann_tpu_torch.ops.fused", "artifact_tables"): TABLES,
    ("molann_tpu_torch.ops.fused_blocked", "artifact_tables"): TABLES,
    **{("molann_tpu_torch.ops.fused", n): PLAIN for n in (
        "KERNEL_LAUNCHES", "backward_plain", "cv_forces_plain",
        "forward_plain", "model_select_mode", "resolve_precision",
        "train_grads_plain")},
    **{("molann_tpu_torch.ops.fused_blocked", n): PLAIN for n in (
        "blocked_backward_plain", "blocked_cv_forces_plain",
        "blocked_forward_plain", "blocked_train_grads_plain",
        "chunk_matrix", "gradient_jump_slack")},
    **{("molann_tpu_torch.systems", n): (
        "the models at the unrolled kernels' edge: scripts/tpu_validation.py's "
        "config 5, built there inline, and the envelope's corner")
       for n in ("chignolin_model", "envelope_corner_model")},
}

# qualified name of a public callable whose signature differs
SIGNATURE = {
    "molann_tpu_torch.models.ann.AlignmentLayer": DEVICE,
    "molann_tpu_torch.models.ann.SequentialNN": MODULE,
    "molann_tpu_torch.models.ann.Identity": MODULE,
    "molann_tpu_torch.models.ann.create_sequential_nn": GENERATOR,
    "molann_tpu_torch.io.serialize.load_model": DEVICE,
    "molann_tpu_torch.io.torch_import.load_torchscript": DEVICE,
    "molann_tpu_torch.pbc.wrap": DEVICE,
    "molann_tpu_torch.pbc.minimum_image": DEVICE,
    "molann_tpu_torch.pbc.unwrap_time": DEVICE,
    "molann_tpu_torch.pbc.make_whole": DEVICE,
    "molann_tpu_torch.serve.evaluate_trajectory": DEVICE,
    "molann_tpu_torch.systems.alanine_model": GENERATOR,
    "molann_tpu_torch.systems.peptide_model": GENERATOR,
    "molann_tpu_torch.systems.lj_fluid_model": GENERATOR,
    "molann_tpu_torch.train.loop.make_train_step": f"{OPTIMIZER}; {DONATE}",
    "molann_tpu_torch.train.loop.make_fused_train_step": f"{OPTIMIZER}; {DONATE}",
    "molann_tpu_torch.train.ensemble.make_ensemble_train_step": (
        f"{OPTIMIZER}; {DONATE}"),
    "molann_tpu_torch.train.checkpoint.save_training_state": OPTIMIZER,
    "molann_tpu_torch.parallel.multihost.initialize_multihost": BACKEND,
    "molann_tpu_torch.parallel.data_parallel.psum_mean_grads": MESH_ARG,
    "molann_tpu_torch.train.checkpoint.load_training_state": DEVICE,
    **{f"molann_tpu_torch.sampling.{name}": GENERATOR for name in (
        "langevin.overdamped_langevin", "langevin.baoab_langevin",
        "bias.steered_langevin", "bias.metadynamics_langevin",
        "opes.opes_langevin", "mbar.umbrella_sampling",
        "remd.replica_exchange_langevin",
        "committor.empirical_committor")},
}

# public callables whose signature is the reference's and whose meaning
# differs by design: one process per device over torch.distributed, where
# JAX has one controller over every device
MEANING = {
    "molann_tpu_torch.parallel.mesh.data_mesh": (
        "a DataMesh of this rank's place on the ranks of the process group, "
        "where JAX builds a Mesh of devices; devices= is this rank's device "
        "(or a list indexed by rank), where JAX takes the devices to span"),
    "molann_tpu_torch.parallel.mesh.batch_sharding": (
        "a function giving this rank's contiguous rows on its device, where "
        "JAX returns a NamedSharding of the leading dimension"),
    "molann_tpu_torch.parallel.mesh.replicated_sharding": (
        "the mesh's device, where the replicated parameters live, where JAX "
        "returns a replicated NamedSharding"),
    "molann_tpu_torch.parallel.multihost.global_batch": (
        "the rank's rows moved to its device: the global batch is the ranks' "
        "rows together, where JAX assembles one global array"),
    "molann_tpu_torch.serve.make_serving_fn": (
        "the returned function gives this rank's rows' outputs, what JAX's "
        "sharded output holds on the local devices"),
}

# the sampling modules the port has, all of the reference's
SAMPLING_MODULES = ("bias", "committor", "langevin", "mbar", "msm", "opes",
                    "pathcv", "potentials", "remd", "string", "tpt")

# the port's modules without a counterpart, and why
OWN_MODULES = {
    "molann_tpu_torch._device": "the port's device rule",
    "molann_tpu_torch.ops._build": "the nvcc build of the CUDA kernels",
    "molann_tpu_torch.train.optim": "optax's rules as torch.optim classes",
    "molann_tpu_torch.utils.gen_docs": (
        "the JAX package's scripts/gen_docs.py, which sits outside that "
        "package, as a module of the port"),
    "molann_tpu_torch.utils.build_docs_site": (
        "the JAX package's scripts/build_docs_site.py, which sits outside "
        "that package, as a module of the port"),
    **{f"molann_tpu_torch.examples{sub}": (
        "the JAX package's examples/*.py, which sit outside that package, "
        "as modules of the port") for sub in (
            "", ".serve_biased_md", ".train_autoencoder_cv",
            ".condensed_phase_cv", ".committor_cv", ".committee_uncertainty",
            ".biased_dynamics", ".train_eigenfunction_cv",
            ".train_timelagged_cv", ".adaptive_cv_loop", ".path_kinetics")},
}


def _plain_value(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    return isinstance(v, tuple) and all(_plain_value(e) for e in v)


def _signature_differs(port, ref):
    try:
        ps, rs = inspect.signature(port), inspect.signature(ref)
    except (TypeError, ValueError):
        return False
    pp, rp = list(ps.parameters.values()), list(rs.parameters.values())
    if [(p.name, p.kind) for p in pp] != [(p.name, p.kind) for p in rp]:
        return True
    return any(_plain_value(r.default) and r.default is not inspect._empty
               and p.default != r.default for p, r in zip(pp, rp))


def _port_modules():
    names = ["molann_tpu_torch"]
    for m in pkgutil.walk_packages(molann_tpu_torch.__path__,
                                   "molann_tpu_torch."):
        if ".probes" not in m.name:
            names.append(m.name)
    return sorted(names)


def _differences():
    missing, extra, sigs, unmatched = {}, {}, set(), set()
    for name in _port_modules():
        pm = importlib.import_module(name)
        ref_name = "molann_tpu" + name[len("molann_tpu_torch"):]
        try:
            rm = importlib.import_module(ref_name)
        except ModuleNotFoundError:
            unmatched.add(name)
            continue
        pa, ra = getattr(pm, "__all__", None), getattr(rm, "__all__", None)
        if (pa is None) != (ra is None):
            missing[(name, "__all__")] = "one side has no __all__"
            continue
        if pa is None:
            continue
        for n in set(ra) - set(pa):
            missing[(name, n)] = True
        for n in set(pa) - set(ra):
            extra[(name, n)] = True
        for n in set(pa) & set(ra):
            po, ro = getattr(pm, n), getattr(rm, n)
            if callable(po) and callable(ro) and _signature_differs(po, ro):
                sigs.add(f"{po.__module__}.{po.__qualname__}")
    return missing, extra, sigs, unmatched


@pytest.fixture(scope="module")
def differences():
    return _differences()


def test_all_names_match_the_reference(differences):
    """Every name of a reference module's ``__all__`` is in the port's,
    and every port name is the reference's, except those listed."""
    missing, extra, _, _ = differences
    assert set(missing) == set(MISSING)
    assert set(extra) == set(EXTRA)


def test_signatures_match_the_reference(differences):
    """Every public callable's parameters match the reference's, except
    the listed by-design differences."""
    assert differences[2] == set(SIGNATURE)


def test_modules_without_a_counterpart_are_listed(differences):
    assert differences[3] == set(OWN_MODULES)


def test_changed_meanings_are_listed(differences):
    """Each name of ``MEANING`` is exported by the port and the reference
    with one signature: the difference is in what it returns."""
    _, _, sigs, _ = differences
    for q in MEANING:
        mod, name = q.rsplit(".", 1)
        pm = importlib.import_module(mod)
        rm = importlib.import_module("molann_tpu" + mod[len("molann_tpu_torch"):])
        assert name in pm.__all__ and name in rm.__all__, q
        assert q not in sigs, q


def test_reasons_are_written():
    for table in (MISSING, EXTRA, SIGNATURE, OWN_MODULES, MEANING):
        assert all(isinstance(r, str) and len(r) > 10
                   for r in table.values())


def test_repaired_entry_points():
    """The calls of ROADMAP queue 3 item 3 that used to fail: the
    reference's imports, aliases, positional order and keywords."""
    import numpy as np
    import torch

    import molann_tpu_torch as P
    from molann_tpu_torch import ops, pbc, train
    from molann_tpu_torch.ops import alignment, fused, fused_blocked
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.systems import alanine_model, peptide_model

    assert P.pbc is pbc
    assert P.fused_train_grads is fused.fused_train_grads
    assert P.active_atom_indices is fused.active_atom_indices
    assert ops.neighbor.cull_model is ops.cull_model
    assert train.loss_registry is train.registry
    model, u = alanine_model(device="cpu")
    x = torch.as_tensor(u.atoms.positions[None].repeat(4, 0))
    spec, align_idx, ref_x, params, act = fused._extract_model(model)
    y = fused.fused_apply(spec, align_idx, act, (None, None), False, params,
                          ref_x, x)
    torch.testing.assert_close(y, model(x), rtol=0, atol=1e-5)
    # the reference's nested [d_out, 1] biases
    y1 = fused.fused_apply(spec, align_idx, act, (None, None), False,
                           tuple((w, b[:, None]) for w, b in params), ref_x,
                           x)
    torch.testing.assert_close(y1, y, rtol=0, atol=0)
    sub = x[:, list(align_idx)]
    H = alignment.kabsch_covariance(sub - sub.mean(1, keepdim=True), ref_x,
                                    precision="highest")
    R = fused.qcp_rotation([[H[:, i, j] for j in range(3)]
                            for i in range(3)])
    want = alignment.rotation_qcp(H)
    for j in range(3):
        for i in range(3):
            torch.testing.assert_close(R[j][i], want[:, j, i])
    np.testing.assert_allclose(
        alignment.align_frames(x, ref_x, align_idx, precision="highest"),
        alignment.align_frames(x, ref_x, align_idx), atol=0)
    with pytest.raises(ValueError, match="precision"):
        alignment.align_frames(x, ref_x, align_idx, precision="fp7")
    evaluate_trajectory(model, x.numpy(), device="cpu", interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        evaluate_trajectory(model, x.numpy(), device="cpu", interpret="yes")
    pm, pu = peptide_model(12, device="cpu")
    xp = torch.as_tensor(pu.atoms.positions[None].repeat(3, 0))
    parts = fused._extract_model(pm)
    yb = fused_blocked.blocked_apply(parts[0], parts[1], parts[4],
                                     (32, 32), False, "exact", parts[3],
                                     parts[2], xp)
    torch.testing.assert_close(yb, pm(xp), rtol=0, atol=1e-5)
    # the port's old keyword order binds nothing wrongly: it raises
    with pytest.raises(TypeError):
        fused_blocked.blocked_apply(parts[0], parts[1], parts[4], parts[3],
                                    parts[2], xp, precision="exact")
    with pytest.raises(ValueError, match="tile must be"):
        fused_blocked.blocked_apply(parts[0], parts[1], parts[4], parts[3],
                                    parts[2], xp, None, None, None)
    yc, gc = fused_blocked.blocked_cv_forces(
        parts[0], parts[1], parts[4], parts[3], parts[2], xp, tile=64,
        interpret=False)
    assert yc.shape == yb.shape and gc.shape == xp.shape


def test_sampling_matches_the_reference_but_for_generators(differences):
    """``molann_tpu_torch.sampling`` and each of its modules exist with the
    reference's ``__all__`` (the 35 names of the package), and the only
    signature difference in them is ``key`` -> ``generator``."""
    import molann_tpu.sampling as ref
    import molann_tpu_torch.sampling as port

    assert port.__all__ == ref.__all__ and len(port.__all__) == 35
    missing, extra, sigs, unmatched = differences
    for name in SAMPLING_MODULES:
        assert f"molann_tpu_torch.sampling.{name}" in _port_modules()
    assert not any(".sampling" in m for m, _ in list(missing) + list(extra))
    assert not any(".sampling" in m for m in unmatched)
    ours = {q for q in sigs if ".sampling." in q}
    assert ours and all(SIGNATURE[q] == GENERATOR for q in ours)
    for q in ours:
        mod, fn = q.rsplit(".", 1)
        p = inspect.signature(getattr(importlib.import_module(mod), fn))
        r = inspect.signature(getattr(importlib.import_module(
            "molann_tpu" + mod[len("molann_tpu_torch"):]), fn))
        rename = ["generator" if n == "key" else n for n in r.parameters]
        assert list(p.parameters) == rename, q
