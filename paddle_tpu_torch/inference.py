"""Generative artifacts: export and load a transformer LM for serving
(the generative part of ``paddle_tpu/inference.py``).

The format is the JAX package's own: ``__gen_params__.pkl`` (a pickled
``{name: np.ndarray}`` dict in ``param_names`` order) and
``__gen_config__.json`` (``{"family": "transformer_lm", "config":
{...}}``). An artifact written by ``paddle_tpu.inference.export_generative``
therefore loads here unchanged, and one written here loads there.

:func:`validate_generative_artifact` also runs the PT034 check
(``analysis/memory.py``): the KV pool the engine would preallocate plus
the resident weights (a speculative pairing's draft and its own pool
folded in) must fit the device's memory budget.

A speculative pairing (:func:`export_speculative`) is one directory in
the JAX package's layout: the target as a generative artifact at the
top, the draft as a whole generative artifact in ``__draft__/``, and
``__spec__.json`` (``{"spec_k": k}``), the depth the pairing was
exported at. Either package loads a pairing the other wrote.

The pickle is trusted input: load only artifacts this project wrote.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

__all__ = ["ArtifactError", "DRAFT_SUBDIR", "GEN_CONFIG_FILE",
           "GEN_PARAMS_FILE", "SPEC_CONFIG_FILE", "export_generative",
           "export_speculative", "generative_memory_bytes",
           "is_generative_artifact", "is_speculative_artifact",
           "load_generative", "load_speculative",
           "validate_generative_artifact"]

GEN_PARAMS_FILE = "__gen_params__.pkl"
GEN_CONFIG_FILE = "__gen_config__.json"
# a speculative pairing: the draft's artifact in DRAFT_SUBDIR beside the
# target's files, and the pairing's depth in SPEC_CONFIG_FILE
SPEC_CONFIG_FILE = "__spec__.json"
DRAFT_SUBDIR = "__draft__"


class ArtifactError(ValueError):
    """An artifact directory that cannot be loaded; the message names
    every problem found."""


def is_generative_artifact(dirname):
    """True when ``dirname`` looks like an export_generative directory
    (presence only; :func:`validate_generative_artifact` judges it)."""
    return os.path.isfile(os.path.join(dirname, GEN_CONFIG_FILE))


def validate_generative_artifact(dirname, kv_pages=None, page_tokens=None,
                                 budget_bytes=None, check_pool=True):
    """Problem list (empty = valid), the JAX package's validator: both
    files present and not empty; for a speculative pairing its draft's
    files and the pairing rules; and, with ``check_pool``, PT034: the
    pool the engine would preallocate at ``kv_pages`` x ``page_tokens``
    (defaults ``FLAGS.serve_kv_pages`` / ``FLAGS.serve_page_tokens``)
    plus the resident weights must fit the budget (``budget_bytes``,
    else ``FLAGS.memory_budget_gb``, else the memory of the card this
    process serves on; silent on a process without one). Callers that
    know the deployment's geometry pass it (the serve verb forwards its
    ``--kv_pages`` / ``--page_tokens``); the loaders pass
    ``check_pool=False``."""
    problems = _integrity_problems(dirname)
    if not problems and is_speculative_artifact(dirname):
        problems += _spec_problems(dirname)
    if not problems and check_pool:
        problems += _kv_pool_problems(dirname, kv_pages=kv_pages,
                                      page_tokens=page_tokens,
                                      budget_bytes=budget_bytes)
    return problems


def _gen_geometry(dirname, kv_pages=None, page_tokens=None):
    """The one reader of a generative artifact's sizing inputs:
    ``(layers, heads, head_dim, model_bytes, kv_pages, page_tokens)``,
    the pool knobs defaulted from the flags and the weights priced at
    the size of the params file; None when the artifact is unreadable
    (integrity problems are the validator's findings)."""
    from .flags import FLAGS
    try:
        with open(os.path.join(dirname, GEN_CONFIG_FILE)) as f:
            cfg = json.load(f)["config"]
        hidden, heads = int(cfg["hidden"]), int(cfg["num_heads"])
        layers = int(cfg["num_layers"])
        model_bytes = os.path.getsize(os.path.join(dirname,
                                                   GEN_PARAMS_FILE))
    except Exception:
        return None
    return (layers, heads, hidden // max(heads, 1), model_bytes,
            kv_pages if kv_pages else FLAGS.serve_kv_pages,
            page_tokens if page_tokens else FLAGS.serve_page_tokens)


def generative_memory_bytes(dirname, kv_pages=None, page_tokens=None):
    """Resident bytes one generative artifact costs a serve process: the
    weights plus the KV pool at ``kv_pages`` x ``page_tokens`` (defaults
    from the flags), and for a speculative pairing the draft's weights
    and its own pool of the same geometry. None when the artifact is
    unreadable. The serve verb sums it over the models one process
    loads."""
    from .analysis import memory as _mem
    geo = _gen_geometry(dirname, kv_pages=kv_pages,
                        page_tokens=page_tokens)
    if geo is None:
        return None
    layers, heads, head_dim, model_bytes, pages, ptokens = geo
    total = int(model_bytes) + _mem.kv_pool_bytes(layers, heads, head_dim,
                                                  pages, ptokens)
    if is_speculative_artifact(dirname):
        draft = generative_memory_bytes(
            os.path.join(dirname, DRAFT_SUBDIR), kv_pages=kv_pages,
            page_tokens=page_tokens)
        if draft is None:
            return None
        total += draft
    return total


def _kv_pool_problems(dirname, kv_pages=None, page_tokens=None,
                      budget_bytes=None):
    """The PT034 leg of the validator: [] when no budget is known or the
    artifact is unreadable; a pairing's draft side (weights and pool) is
    folded into the resident bytes."""
    from .analysis import memory as _mem
    budget = (int(budget_bytes) if budget_bytes
              else _mem.resolve_budget_bytes(device=_mem.card()))
    if not budget:
        return []
    geo = _gen_geometry(dirname, kv_pages=kv_pages,
                        page_tokens=page_tokens)
    if geo is None:
        return []
    layers, heads, head_dim, model_bytes, pages, ptokens = geo
    if is_speculative_artifact(dirname):
        draft = generative_memory_bytes(
            os.path.join(dirname, DRAFT_SUBDIR), kv_pages=kv_pages,
            page_tokens=page_tokens)
        if draft is not None:
            model_bytes = int(model_bytes) + int(draft)
    diags = _mem.check_kv_pool(layers, heads, head_dim, pages, ptokens,
                               model_bytes=model_bytes,
                               budget_bytes=budget)
    return [str(d) for d in diags]


def _integrity_problems(dirname):
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
    problems = validate_generative_artifact(dirname, check_pool=False)
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


def _spec_pairing_problems(config, draft_config, spec_k):
    """The pairing rules, shared by export (refuse to write a broken
    pairing) and validation: identical vocabularies (the accept rule
    compares token ids), a draft context that covers every position
    the target can decode at, and k >= 1."""
    problems = []
    try:
        k = int(spec_k)
    except (TypeError, ValueError):
        k = 0
    if k < 1:
        problems.append("speculation depth k must be an int >= 1, got "
                        "%r" % (spec_k,))
    if config.vocab_size != draft_config.vocab_size:
        problems.append(
            "draft vocab_size=%d != target vocab_size=%d — speculative "
            "accept compares token ids, the vocabularies must be "
            "identical" % (draft_config.vocab_size, config.vocab_size))
    if draft_config.max_seq < config.max_seq:
        problems.append(
            "draft max_seq=%d < target max_seq=%d — the draft must "
            "cover every position the target can decode at"
            % (draft_config.max_seq, config.max_seq))
    return problems


def is_speculative_artifact(dirname):
    """True when ``dirname`` looks like an export_speculative directory
    (a generative artifact carrying a ``__spec__.json`` pairing)."""
    return (is_generative_artifact(dirname)
            and os.path.isfile(os.path.join(dirname, SPEC_CONFIG_FILE)))


def _spec_problems(dirname):
    """The pairing's problem list, for a speculative artifact whose
    target side is intact."""
    from .models import transformer as _tm
    try:
        with open(os.path.join(dirname, SPEC_CONFIG_FILE)) as f:
            spec_k = json.load(f)["spec_k"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        return ["%s is corrupt or incomplete (%s: %s) — re-export with "
                "export_speculative" % (SPEC_CONFIG_FILE,
                                        type(e).__name__, e)]
    draft_dir = os.path.join(dirname, DRAFT_SUBDIR)
    problems = ["draft artifact (%s/): %s" % (DRAFT_SUBDIR, p)
                for p in _integrity_problems(draft_dir)]
    if problems:
        return problems
    try:
        configs = []
        for d in (dirname, draft_dir):
            with open(os.path.join(d, GEN_CONFIG_FILE)) as f:
                configs.append(_tm.TransformerConfig.from_dict(
                    json.load(f)["config"]))
    except (OSError, ValueError, KeyError, TypeError) as e:
        return ["config JSON unreadable while checking the speculative "
                "pairing (%s: %s)" % (type(e).__name__, e)]
    return _spec_pairing_problems(configs[0], configs[1], spec_k)


def export_speculative(dirname, config, draft_config, spec_k, params=None,
                       draft_params=None, scope=None, draft_scope=None):
    """Write a target + draft pairing for speculative decoding as one
    directory (the JAX package's layout and signature). Refuses a
    pairing the engine would refuse to build (vocabularies differ, the
    draft's context is shorter, k < 1)."""
    from .models import transformer as _tm
    if isinstance(config, dict):
        config = _tm.TransformerConfig.from_dict(config)
    if isinstance(draft_config, dict):
        draft_config = _tm.TransformerConfig.from_dict(draft_config)
    problems = _spec_pairing_problems(config, draft_config, spec_k)
    if problems:
        raise ValueError("cannot export speculative pairing:\n  - %s"
                         % "\n  - ".join(problems))
    export_generative(dirname, config, scope=scope, params=params)
    export_generative(os.path.join(dirname, DRAFT_SUBDIR), draft_config,
                      scope=draft_scope, params=draft_params)
    with open(os.path.join(dirname, SPEC_CONFIG_FILE), "w") as f:
        json.dump({"spec_k": int(spec_k)}, f)
    return dirname


def load_speculative(dirname, device="cuda"):
    """Load a speculative pairing as ``(target, draft, spec_k)``, both
    :class:`~paddle_tpu_torch.models.transformer.TransformerLM` on
    ``device``. Raises :class:`ArtifactError` naming every problem, the
    pairing's included: the two load together or not at all."""
    if is_speculative_artifact(dirname):
        problems = validate_generative_artifact(dirname, check_pool=False)
    else:
        problems = ["missing %s (speculative pairing metadata) — export "
                    "with export_speculative" % SPEC_CONFIG_FILE]
    if problems:
        raise ArtifactError("cannot load speculative artifact %r:\n  - %s"
                            % (dirname, "\n  - ".join(problems)))
    target = load_generative(dirname, device=device)
    draft = load_generative(os.path.join(dirname, DRAFT_SUBDIR),
                            device=device)
    with open(os.path.join(dirname, SPEC_CONFIG_FILE)) as f:
        spec_k = int(json.load(f)["spec_k"])
    return target, draft, spec_k
