"""Generative artifacts: export and load a transformer LM for serving
(the generative part of ``paddle_tpu/inference.py``).

The format is the JAX package's own: ``__gen_params__.pkl`` (a pickled
``{name: np.ndarray}`` dict in ``param_names`` order) and
``__gen_config__.json`` (``{"family": "transformer_lm", "config":
{...}}``). An artifact written by ``paddle_tpu.inference.export_generative``
therefore loads here unchanged, and one written here loads there.

The pickle is trusted input: load only artifacts this project wrote.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

__all__ = ["ArtifactError", "GEN_CONFIG_FILE", "GEN_PARAMS_FILE",
           "export_generative", "is_generative_artifact", "load_generative",
           "validate_generative_artifact"]

GEN_PARAMS_FILE = "__gen_params__.pkl"
GEN_CONFIG_FILE = "__gen_config__.json"


class ArtifactError(ValueError):
    """An artifact directory that cannot be loaded; the message names
    every problem found."""


def is_generative_artifact(dirname):
    """True when ``dirname`` looks like an export_generative directory
    (presence only; :func:`validate_generative_artifact` judges it)."""
    return os.path.isfile(os.path.join(dirname, GEN_CONFIG_FILE))


def validate_generative_artifact(dirname):
    """Problem list (empty = valid): the integrity half of the JAX
    package's validator (both files present and not empty). Pool sizing
    against a memory budget is not ported."""
    if not os.path.isdir(dirname):
        return ["artifact directory %r does not exist (expected the "
                "directory export_generative wrote)" % dirname]
    problems = []
    for fname, role in ((GEN_CONFIG_FILE, "model config JSON"),
                        (GEN_PARAMS_FILE, "pickled parameters")):
        path = os.path.join(dirname, fname)
        if not os.path.isfile(path):
            problems.append("missing %s (%s)" % (fname, role))
        elif os.path.getsize(path) == 0:
            problems.append("%s is empty (%s)" % (fname, role))
    return problems


def export_generative(dirname, config, scope=None, params=None):
    """Write a transformer LM as a generative artifact; the JAX
    package's signature. ``config``: a TransformerConfig or its dict.
    ``params``: {name: array}, numpy or tensors; by default the
    transformer_lm parameters are taken from ``scope`` (default the
    global scope) by ``models.transformer.params_from_scope``."""
    from .models import transformer as _tm
    if isinstance(config, dict):
        config = _tm.TransformerConfig.from_dict(config)
    if params is None:
        params = _tm.params_from_scope(config, scope)
    missing = [n for n in _tm.param_names(config) if n not in params]
    if missing:
        raise ValueError("params dict is missing %s" % missing)

    def host(a):
        return a.detach().cpu().numpy() if hasattr(a, "detach") \
            else np.asarray(a)

    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, GEN_PARAMS_FILE), "wb") as f:
        pickle.dump({n: host(params[n]) for n in _tm.param_names(config)},
                    f)
    with open(os.path.join(dirname, GEN_CONFIG_FILE), "w") as f:
        json.dump({"family": "transformer_lm",
                   "config": config.to_dict()}, f)
    return dirname


def load_generative(dirname, device="cuda"):
    """Load a generative artifact as a
    :class:`~paddle_tpu_torch.models.transformer.TransformerLM` with its
    weights on ``device``. Raises :class:`ArtifactError` naming every
    problem."""
    from .models import transformer as _tm
    problems = validate_generative_artifact(dirname)
    if problems:
        raise ArtifactError("cannot load generative artifact %r:\n  - %s"
                            % (dirname, "\n  - ".join(problems)))
    try:
        with open(os.path.join(dirname, GEN_CONFIG_FILE)) as f:
            meta = json.load(f)
        family = meta["family"]
        config = _tm.TransformerConfig.from_dict(meta["config"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise ArtifactError(
            "artifact %r: %s is corrupt or incomplete (%s: %s) — "
            "re-export with export_generative"
            % (dirname, GEN_CONFIG_FILE, type(e).__name__, e)) from e
    if family != "transformer_lm":
        raise ArtifactError(
            "artifact %r: unknown generative family %r (this build "
            "serves 'transformer_lm')" % (dirname, family))
    try:
        with open(os.path.join(dirname, GEN_PARAMS_FILE), "rb") as f:
            params = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        raise ArtifactError(
            "artifact %r: %s is corrupt (%s: %s) — re-export with "
            "export_generative" % (dirname, GEN_PARAMS_FILE,
                                   type(e).__name__, e)) from e
    try:
        return _tm.TransformerLM.from_numpy(params, config, device=device)
    except ValueError as e:
        raise ArtifactError("artifact %r: %s" % (dirname, e)) from e
