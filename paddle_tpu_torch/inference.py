"""Inference artifacts: compiled models for ``:predict`` and generative
transformer LMs for ``:generate`` (counterpart of
``paddle_tpu/inference.py``; its native tier, ``__module__.stablehlo_bc``
and the C ABI, is not ported).

A compiled artifact (:func:`export_compiled`, :class:`CompiledModel`)
cannot be StableHLO here: it holds the pruned inference Program in the
port's ``__model__`` form (``io.py``, the same pickle rules), beside
``__params__.pkl`` (``{name: np.ndarray}``) and ``__meta__.json``, which
keep the JAX package's names and keys. :class:`CompiledModel` runs the
Program through an Executor on the compiled path: its first run is an
eager warm-up, its second captures a CUDA graph and later runs replay
it. ``run_many`` runs R requests as R replays of that one-request step,
so each is bit-identical to the request run alone. Its conv2d ops keep
their ``conv_impl`` attr, so a ResNet exported under ``pallas3x3``
launches the conv3x3 kernel whatever the serving process's flag. A JAX
artifact (``__compiled__.stablehlo``, no ``__model__``) is refused, and
``feed_spec`` reports a feed's own dtype where JAX's canonical avals
narrow int64 to int32 (ROADMAP.md Queue 3 #39).

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
import threading

import numpy as np

__all__ = ["ArtifactError", "CompiledModel", "DRAFT_SUBDIR",
           "EXPORTED_FILE", "GEN_CONFIG_FILE", "GEN_PARAMS_FILE",
           "META_FILE", "MODEL_FILE", "PARAMS_FILE", "SPEC_CONFIG_FILE",
           "export_compiled", "export_generative", "export_speculative",
           "generative_memory_bytes", "is_generative_artifact",
           "is_speculative_artifact", "load_compiled", "load_generative",
           "load_speculative", "validate_artifact",
           "validate_generative_artifact"]

# a compiled artifact: the pruned Program, its parameters, its feeds and
# fetches (the JAX package's names for the last two)
MODEL_FILE = "__model__"
PARAMS_FILE = "__params__.pkl"
META_FILE = "__meta__.json"
# the JAX package's StableHLO program, which the port cannot run
EXPORTED_FILE = "__compiled__.stablehlo"

GEN_PARAMS_FILE = "__gen_params__.pkl"
GEN_CONFIG_FILE = "__gen_config__.json"
# a speculative pairing: the draft's artifact in DRAFT_SUBDIR beside the
# target's files, and the pairing's depth in SPEC_CONFIG_FILE
SPEC_CONFIG_FILE = "__spec__.json"
DRAFT_SUBDIR = "__draft__"


class ArtifactError(ValueError):
    """An artifact directory that cannot be loaded; the message names
    every problem found."""


# -- compiled artifacts -------------------------------------------------------

def validate_artifact(dirname):
    """Problem list of a compiled artifact (empty = valid), stat only:
    a missing directory, each missing or empty ``__model__`` /
    ``__params__.pkl`` / ``__meta__.json``, and a JAX artifact, whose
    StableHLO program the port cannot run (Queue 3 #39).
    :class:`CompiledModel` runs it before loading and reports corrupt
    contents with the same error type."""
    if not os.path.isdir(dirname):
        return ["artifact directory %r does not exist (expected the "
                "directory export_compiled wrote)" % dirname]
    if (os.path.isfile(os.path.join(dirname, EXPORTED_FILE))
            and not os.path.isfile(os.path.join(dirname, MODEL_FILE))):
        return ["%s without %s: a JAX package artifact (a StableHLO "
                "program), which this package cannot run; export the "
                "model with paddle_tpu_torch.inference.export_compiled"
                % (EXPORTED_FILE, MODEL_FILE)]
    problems = []
    for fname, role in ((MODEL_FILE, "pickled inference Program"),
                        (PARAMS_FILE, "pickled parameters"),
                        (META_FILE, "feed/fetch metadata")):
        path = os.path.join(dirname, fname)
        if not os.path.isfile(path):
            problems.append("missing %s (%s)" % (fname, role))
        elif os.path.getsize(path) == 0:
            problems.append("%s is empty (%s)" % (fname, role))
    return problems


def export_compiled(dirname, feeded_var_names, target_vars, executor,
                    main_program=None, example_feed=None, scope=None,
                    amp=False):
    """Write the inference slice of ``main_program`` (pruned to
    ``feeded_var_names`` and ``target_vars``) with the persistables it
    reads from ``scope`` (default the global scope); the JAX package's
    signature. ``example_feed`` ({name: array}) fixes each feed's shape
    and dtype, one request's; by default each -1 dim is 1. ``amp=True``
    writes an artifact that runs its matmuls and convs in bfloat16
    wherever it is loaded, the CPU too: the cast decision is pinned by
    the caller's request, not by the device. Returns the fetch names."""
    from .core import ir
    from .core.executor import _to_numpy
    from .core.scope import global_scope
    main_program = main_program or ir.default_main_program()
    scope = scope or global_scope()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    target_vars = ([target_vars] if isinstance(target_vars, ir.Variable)
                   else list(target_vars))
    fetch_names = [v.name if isinstance(v, ir.Variable) else v
                   for v in target_vars]
    pruned = main_program.prune(feeds=feeded_var_names,
                                fetches=fetch_names)
    # prune copies the program: an AMP training program must not leak
    # its marks into an amp=False export
    pruned._amp = bool(amp)
    pruned._amp_pure = False
    block = pruned.global_block()
    needed = set()
    for op in block.ops:
        needed.update(op.input_arg_names)
    params = {}
    for n in sorted(needed):
        v = scope.find_var(n) if n not in feeded_var_names else None
        if v is not None:
            params[n] = _to_numpy(v) if hasattr(v, "detach") \
                else np.asarray(v)
    if example_feed is None:
        example_feed = {}
        for n in feeded_var_names:
            v = block.var(n)
            shape = tuple(1 if d in (-1, None) else d
                          for d in (v.shape or (1,)))
            example_feed[n] = np.zeros(shape, dtype=str(v.dtype))
    feed_order = sorted(feeded_var_names)
    examples = {n: np.asarray(example_feed[n]) for n in feed_order}
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, MODEL_FILE), "wb") as f:
        pickle.dump({"program": pruned, "feed_names": feed_order,
                     "fetch_names": fetch_names}, f)
    with open(os.path.join(dirname, PARAMS_FILE), "wb") as f:
        pickle.dump(params, f)
    with open(os.path.join(dirname, META_FILE), "w") as f:
        json.dump({"feed_names": feed_order, "fetch_names": fetch_names,
                   "feed_shapes": {n: list(a.shape)
                                   for n, a in examples.items()},
                   "feed_dtypes": {n: str(a.dtype)
                                   for n, a in examples.items()},
                   "amp": bool(amp)}, f)
    return fetch_names


class CompiledModel(object):
    """A loaded compiled artifact on ``device`` (default ``cuda``; no
    card raises, the port never falls back to the CPU on its own).
    Thread-safe: runs are serialized on the model's Executor."""

    def __init__(self, dirname, device="cuda"):
        from . import io as _io
        from .core.executor import Executor, _to_device_value
        from .core.scope import Scope
        from .device import resolve_device
        problems = validate_artifact(dirname)
        if problems:
            raise ArtifactError("cannot load compiled artifact %r:\n  - %s"
                                % (dirname, "\n  - ".join(problems)))
        self.device = resolve_device(device)
        self.dirname = dirname
        try:
            with open(os.path.join(dirname, MODEL_FILE), "rb") as f:
                payload = _io._ModelUnpickler(f).load()
            program = _io._adopt(payload["program"])
        except Exception as e:
            raise ArtifactError(
                "artifact %r: %s is corrupt (%s: %s) — re-export with "
                "export_compiled" % (dirname, MODEL_FILE,
                                     type(e).__name__, e)) from e
        try:
            with open(os.path.join(dirname, PARAMS_FILE), "rb") as f:
                params = _io._ModelUnpickler(f).load()
            if not isinstance(params, dict):
                raise TypeError("not a {name: array} dict")
        except Exception as e:
            raise ArtifactError(
                "artifact %r: %s is corrupt (%s: %s) — re-export with "
                "export_compiled" % (dirname, PARAMS_FILE,
                                     type(e).__name__, e)) from e
        try:
            with open(os.path.join(dirname, META_FILE)) as f:
                meta = json.load(f)
            self.feed_names = list(meta["feed_names"])
            self.fetch_names = list(meta["fetch_names"])
            self._spec = {n: (tuple(int(d) for d in meta["feed_shapes"][n]),
                              str(meta["feed_dtypes"][n]))
                          for n in self.feed_names}
            amp = bool(meta.get("amp", False))
        except Exception as e:
            raise ArtifactError(
                "artifact %r: %s is corrupt or incomplete (%s: %s) — "
                "re-export with export_compiled"
                % (dirname, META_FILE, type(e).__name__, e)) from e
        program._amp = amp
        program._amp_pure = False
        program._amp_pinned = amp
        self._program = program
        # the weights stay on the device for the model's lifetime
        self._scope = Scope()
        for n, a in params.items():
            self._scope.set_var(n, _to_device_value(np.array(a),
                                                    self.device))
        self._exe = Executor(self.device)
        self._lock = threading.Lock()

    @property
    def feed_spec(self):
        """``{feed name: (shape, dtype str)}``, one request's: what a
        serving tier checks a request against and shapes its warm-up
        zeros from."""
        return dict(self._spec)

    @property
    def stats(self):
        """The Executor's run counters and ``compiled_steps``, the steps
        it keeps (one per feed signature)."""
        with self._lock:
            out = dict(self._exe.stats)
            out["compiled_steps"] = len(self._exe._cache)
        return out

    def _feed_val(self, a):
        """A tensor on the model's device passes through untouched; any
        other array-like is copied there."""
        import torch
        if isinstance(a, torch.Tensor) and a.device == self.device:
            return a
        from .core.executor import _to_device_value
        return _to_device_value(a, self.device)

    def stage(self, feed):
        """Copy a feed to the device ahead of :meth:`run` /
        :meth:`run_many`."""
        return {n: self._feed_val(feed[n]) for n in self.feed_names}

    def _run_locked(self, feed):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self.fetch_names,
                             scope=self._scope, return_numpy=False)

    def run(self, feed):
        """One request: a list of tensors on the device, one a fetch."""
        feed = self.stage(feed)
        with self._lock:
            self._set_device()
            return self._run_locked(feed)

    def run_many(self, feeds):
        """R requests stacked on a leading axis (``{name: [R, ...]}``):
        each runs as the one-request step (R replays of its graph), so
        each row is bit-identical to :meth:`run` of that request alone.
        Returns one tensor a fetch with the leading R axis."""
        import torch
        stacked = self.stage(feeds)
        r = int(stacked[self.feed_names[0]].shape[0])
        rows = []
        with self._lock:
            self._set_device()
            for i in range(r):
                rows.append(self._run_locked(
                    {n: v[i] for n, v in stacked.items()}))
        return [torch.stack([row[j] for row in rows])
                for j in range(len(self.fetch_names))]

    def _set_device(self):
        # the calling thread (a dispatch thread) may not have launched on
        # this card before
        if self.device.type == "cuda":
            import torch
            torch.cuda.set_device(self.device)


def load_compiled(dirname, device="cuda"):
    return CompiledModel(dirname, device=device)


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
