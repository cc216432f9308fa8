"""Shared plumbing of the CLI command modules."""

from __future__ import annotations


def _load_model(path, device):
    from ..io import load_model

    return load_model(path, device=device)
