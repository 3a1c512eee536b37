"""The ``:predict`` front on the card.

- A compiled ResNet-50 (224 x 224, 1000 classes, float32, every conv
  with ``conv_impl=pallas3x3``) loaded from its artifact: the captured
  one-request graph holds a conv3x3 kernel node for each of the 16
  3x3 / s1 convs (read from the driver), a bucket of 4 is 4 replays of
  it (64 launches counted), each row bit-identical to the image run
  alone.
- A capture beside a running generative engine: the compiled model
  captures its graph (``capture_error_mode="thread_local"``) while the
  engine's thread launches decode steps; both finish, the tokens are
  the reference decoder's.
- No fallback: a conv3x3 launch that fails fails the request (a 500 on
  the wire, a ``batch_failed`` event) and the plain conv never runs.

JAX-free, so that it runs where the card is.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import inference, kernels, layers, models  # noqa: E402
from paddle_tpu_torch import profiler, resilience  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope  # noqa: E402
from paddle_tpu_torch.flags import flags_guard  # noqa: E402
from paddle_tpu_torch.kernels import conv3x3  # noqa: E402
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402
from paddle_tpu_torch.resilience import events  # noqa: E402
from paddle_tpu_torch.serving import (GenerationEngine,  # noqa: E402
                                      InferenceService, make_server,
                                      reference_decode)

IMAGE, CLASSES = 224, 1000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _no_tune(tmp_path):
    with flags_guard(tune_cache_dir=str(tmp_path / "tune")):
        yield


def _export_resnet50(dev, d, image=IMAGE):
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        img = layers.data("img", shape=[3, image, image], dtype="float32")
        pred = models.resnet(img, class_dim=CLASSES, depth=50,
                             variant="imagenet")
    for op in main.global_block().ops:
        if op.type == "conv2d":
            op.attrs["conv_impl"] = "pallas3x3"
    scope = Scope()
    Executor(dev).run(start, scope=scope)
    inference.export_compiled(
        d, ["img"], [pred], None, main_program=main.clone(for_test=True),
        example_feed={"img": np.zeros((1, 3, image, image), np.float32)},
        scope=scope)
    return d


class _KeptGraph(torch.cuda.CUDAGraph):
    """A graph that keeps its ``cudaGraph_t`` so its nodes can be read."""

    def __new__(cls, keep_graph=False):
        return super().__new__(cls, True)

    def __init__(self, keep_graph=False):
        super().__init__(True)


def _images(n, seed=0, image=IMAGE):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 1, 3, image, image).astype(np.float32)


@pytest.mark.cuda
def test_compiled_resnet50_bucket_holds_conv3x3_nodes(cuda_device,
                                                      tmp_path,
                                                      monkeypatch):
    d = _export_resnet50(cuda_device, str(tmp_path / "r50"))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _KeptGraph)
    model = inference.load_compiled(d, device=cuda_device)
    imgs = _images(4)
    model.run({"img": imgs[0]})          # the eager warm-up
    model.run({"img": imgs[0]})          # the capture
    graphs = [e.graph for e in model._exe._cache.values()
              if e.graph is not None]
    assert len(graphs) == 1
    names = profiler.graph_kernel_names(graphs[0])
    assert sum("conv3x3_kernel" in n for n in names) == 16, names
    kernels.reset_launches()
    outs = model.run_many({"img": imgs})[0]
    assert kernels.launch_counts()["conv3x3_fwd"] == 4 * 16
    assert model.stats["graph_captures"] == 1
    for i in range(4):
        assert torch.equal(outs[i], model.run({"img": imgs[i]})[0])


@pytest.mark.cuda
def test_capture_beside_a_running_generative_engine(cuda_device, tmp_path):
    dev = cuda_device
    cfg = ttm.TransformerConfig(vocab_size=97, hidden=64, num_layers=2,
                                num_heads=2, max_seq=256)
    lm = ttm.TransformerLM.from_numpy(ttm.init_params(cfg, seed=1),
                                      cfg.to_dict(), device=dev)
    d = _export_resnet50(dev, str(tmp_path / "r50"), image=64)
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, 97, 3 + i)) for i in range(8)]
    model = inference.load_compiled(d, device=dev)
    img = _images(1, image=64)[0]
    model.run({"img": img})              # the eager warm-up
    with GenerationEngine(lm, max_running=4, kv_pages=128,
                          page_tokens=16) as eng:
        handles = [eng.submit(p, max_new_tokens=240) for p in prompts]
        while eng.stats["running"] == 0:
            threading.Event().wait(0.001)
        model.run({"img": img})          # captured while the engine runs
        still = sum(not h._done.is_set() for h in handles)
        got = [h.wait(timeout=300).tokens for h in handles]
    st = model.stats
    assert st["graph_captures"] == 1 and st["eager_runs"] == 0
    assert still > 0, "the engine finished before the capture"
    for p, toks in zip(prompts, got):
        assert toks == reference_decode(lm, p, 240)


@pytest.mark.cuda
def test_a_failed_conv3x3_launch_fails_the_batch_not_to_the_plain_conv(
        cuda_device, tmp_path, monkeypatch):
    d = _export_resnet50(cuda_device, str(tmp_path / "r50"), image=64)
    plain = []
    real_ref = conv3x3.conv3x3_reference

    def refuse(*a, **k):
        raise RuntimeError("conv3x3 launch refused (test)")

    monkeypatch.setattr(conv3x3, "_launch", refuse)
    monkeypatch.setattr(conv3x3, "conv3x3_reference",
                        lambda *a, **k: plain.append(1) or real_ref(*a, **k))
    resilience.clear_events()
    with InferenceService(max_batch=2, batch_timeout_ms=0) as svc:
        svc.load_model("r50", d, device=cuda_device, warm=False)
        server = make_server(svc, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            body = json.dumps({"inputs": {"img": _images(
                1, image=64)[0].tolist()}}).encode()
            req = urllib.request.Request(
                "http://127.0.0.1:%d/v1/models/r50:predict"
                % server.server_address[1], data=body,
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=300)
            assert ei.value.code == 500
            assert "conv3x3 launch refused" in json.loads(
                ei.value.read())["error"]
        finally:
            server.shutdown()
            server.server_close()
        assert svc.stats["failed"] == 1
    assert events.events(kind="batch_failed", site="serving.dispatch")
    assert not plain
