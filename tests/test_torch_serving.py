"""recnet_tpu_torch.serving and cli.serve: mirrors of tests/test_serving.py
cases against the port, its import hygiene and its kernel build's failure
mode. Weights come from a numpy seed; nothing here needs JAX."""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest
import torch

from recnet_tpu.data.vocab import Vocab
from recnet_tpu_torch.cli.serve import main as serve_main
from recnet_tpu_torch.cli.serve import make_handler
from recnet_tpu_torch.models.decoder import config_from_train
from recnet_tpu_torch.ops.cuda import build
from recnet_tpu_torch.serving import (Captioner, DeadlineExceeded,
                                      MicroBatcher, ServiceOverloaded)
from recnet_tpu_torch.weights import random_params

from fixtures import WORDS, tiny_train_config

FEAT = 32


def _captioner(batch_size=4, **kw):
    tc = tiny_train_config("unused")
    vocab = Vocab(tc.init_word2idx_dict).build([" ".join(WORDS)], str.split)
    params = random_params(config_from_train(tc, vocab.n_vocabs), seed=0)
    return Captioner(tc, vocab, params, dtype="float32", device="cpu",
                     batch_size=batch_size, **kw)


@pytest.fixture(scope="module")
def captioner():
    return _captioner(use_pallas=True, greedy_segment=4)


def _feats(seed, n, frames=10):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((frames + i, FEAT)).astype(np.float32)
            for i in range(n)]


def test_caption_pads_to_shared_buckets(captioner, monkeypatch):
    """Small requests pad to one power-of-two bucket (at least 8, capped at
    batch_size) by repeating the last row, and the padding is cut off."""
    shapes = []
    real = captioner._decode

    def spy(videos, beam_width):
        shapes.append(tuple(videos.shape))
        return real(videos, beam_width)

    monkeypatch.setattr(captioner, "_decode", spy)
    for n in (1, 2, 3):
        caps = captioner.caption(_feats(n, n))
        assert len(caps) == n and all(isinstance(c, str) for c in caps)
    assert set(shapes) == {(4, 6, FEAT)}
    assert len(captioner.caption(_feats(4, 7))) == 7   # 4 + padded 3
    assert _captioner(batch_size=64)._bucket_size(9) == 16
    assert _captioner(batch_size=64)._bucket_size(1) == 8


def test_kernel_route_equals_plain_route(captioner):
    """use_pallas (K2 segments, or K1) and the plain greedy path caption
    alike, and repeat themselves."""
    feats = _feats(5, 6)
    want = _captioner().caption(feats)
    assert captioner.caption(feats) == want
    assert captioner.caption(feats) == want
    assert _captioner(use_pallas=True).caption(feats) == want


def test_validate_features(captioner):
    rng = np.random.default_rng(7)
    good = rng.standard_normal((8, FEAT)).astype(np.float32)
    captioner.validate_features([good])
    for bad in (rng.standard_normal((8, 7)), rng.standard_normal((8,)),
                np.zeros((0, FEAT), np.float32)):
        with pytest.raises(ValueError):
            captioner.validate_features([good, bad])


def test_unported_modes_raise(captioner, monkeypatch):
    with pytest.raises(NotImplementedError, match="item 6"):
        captioner.caption(_feats(1, 2), beam_width=3)
    with pytest.raises(NotImplementedError, match="item 11"):
        _captioner(mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc = tiny_train_config("unused")
        Captioner(tc, Vocab(tc.init_word2idx_dict),
                  random_params(config_from_train(tc, 3), 0), device="cuda")


def test_http_endpoint(captioner):
    """/healthz and /caption over real HTTP: 200, 400 for malformed input,
    404 for an unknown path, 500 for beam (not ported yet)."""
    server = HTTPServer(("127.0.0.1", 0), make_handler(captioner, "tiny"))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def status(path, payload=None):
        try:
            if payload is None:
                urllib.request.urlopen(base + path, timeout=30)
            else:
                post(path, payload)
        except urllib.error.HTTPError as e:
            return e.code
        return 200

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True, "model": "tiny"}
        feats = [f.tolist() for f in _feats(6, 3)]
        out = post("/caption", {"features": feats})
        assert out["captions"] == captioner.caption(
            [np.asarray(f, np.float32) for f in feats])
        assert status("/caption", {"features": [[1.0, 2.0]]}) == 400
        assert status("/caption", {"features": []}) == 400
        assert status("/caption", {"nope": 1}) == 400
        assert status("/nope", {"features": feats}) == 404
        assert status("/nope") == 404
        assert status("/caption", {"features": feats, "beam": 2}) == 500
        assert post("/caption", {"features": feats}) == out
    finally:
        server.shutdown()


class _FakeCaptioner:
    """Records every dispatch; captions each video by its float id."""

    def __init__(self, batch_size=16, delay_s=0.0):
        self.batch_size = batch_size
        self.delay_s = delay_s
        self.calls = []

    def caption(self, features, beam_width=None):
        self.calls.append((len(features), beam_width))
        time.sleep(self.delay_s)
        return [f"cap{int(f[0, 0])}-b{beam_width}" for f in features]


def _id_feat(i):
    return np.full((2, 3), float(i), np.float32)


def _run_clients(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_microbatcher_coalesces_concurrent_requests():
    fake = _FakeCaptioner()
    mb = MicroBatcher(fake, flush_ms=80.0)
    results = {}
    _run_clients(lambda i: results.__setitem__(i, mb.caption([_id_feat(i)])),
                 6)
    mb.close()
    assert results == {i: [f"cap{i}-bNone"] for i in range(6)}
    assert max(n for n, _ in fake.calls) > 1
    assert mb.n_requests == 6 and mb.n_coalesced >= 1
    assert mb.n_dispatches < 6


def test_microbatcher_sheds_when_queue_full():
    fake = _FakeCaptioner(batch_size=2, delay_s=0.25)
    mb = MicroBatcher(fake, flush_ms=20.0, max_batch=2, max_queue=2)
    ok, shed = [], []

    def client(i):
        try:
            ok.append(mb.caption([_id_feat(i)]))
        except ServiceOverloaded:
            shed.append(i)

    _run_clients(client, 12)
    mb.close()
    assert shed and ok and len(ok) + len(shed) == 12
    assert mb.n_rejected == len(shed)


def test_microbatcher_counts_an_expired_request_once():
    """A request whose caller gives up while it still waits in the queue
    (the dispatch thread is busy) is counted once and never dispatched."""
    fake = _FakeCaptioner(batch_size=1, delay_s=0.6)
    mb = MicroBatcher(fake, flush_ms=1.0, max_batch=1, deadline_s=0.2)
    results = {}

    def client(i):
        try:
            results[i] = mb.caption([_id_feat(i)])
        except DeadlineExceeded:
            results[i] = "deadline"

    _run_clients(client, 2)
    mb.close()
    assert list(results.values()).count("deadline") == 2
    assert mb.n_expired == 2
    assert len(fake.calls) <= 1        # the queued one never ran


def test_serve_cli_rejects_sequential_with_overload_knobs():
    for extra in (["--max_queue", "8"], ["--deadline_s", "2"]):
        with pytest.raises(SystemExit):
            serve_main(["--ckpt", "/nonexistent", "--sequential"] + extra)


def test_port_imports_leave_jax_out():
    code = ("import sys, pkgutil, importlib, recnet_tpu_torch\n"
            "for m in pkgutil.walk_packages(recnet_tpu_torch.__path__, "
            "'recnet_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import recnet_tpu_torch.serving, recnet_tpu_torch.cli.serve\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises a clear error; nothing falls back."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libraries", {})
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.load("whole_decode")
    assert not (tmp_path / "build").exists()
