"""The ten workflow examples on the port, one module each, the counterparts
of the JAX package's ``examples/*.py``: the same stages, systems, widths,
step counts, hyper-parameters and returned keys.

Each runs on the card as ``python -m molann_tpu_torch.examples.<name>``;
``main(quick=True, device="cpu")`` runs one on the host at the quick size
the tests use. ``device=None`` means the card, and a ``RuntimeError``
where there is none: no example falls back to the host on its own.

- :mod:`.serve_biased_md`: CVs and biasing forces served from a ``.dcd``
  through K4 (``fused_cv_forces``);
- :mod:`.train_autoencoder_cv`: an autoencoder CV, saved and exported as
  an engine artifact with its gradient;
- :mod:`.condensed_phase_cv`: coordination shells over a Lennard-Jones
  fluid, an HLDA CV, served through K6 (``mode="blocked"``);
- :mod:`.committor_cv`: a committor CV checked by first-passage runs;
- :mod:`.committee_uncertainty`: committee disagreement flags the basin
  never sampled;
- :mod:`.biased_dynamics`: metadynamics along a trained CV escapes;
- :mod:`.train_eigenfunction_cv`: generator eigenfunctions from
  reweighted metadynamics;
- :mod:`.train_timelagged_cv`: a VAMP-2 CV against linear TICA;
- :mod:`.adaptive_cv_loop`: rounds of metadynamics and retraining;
- :mod:`.path_kinetics`: string, path CVs, MSM and transition path
  theory on a two-dimensional valley.
"""
