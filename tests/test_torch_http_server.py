"""The port's HTTP frontend over loopback, on the CPU.

``ServingFrontend`` owns a ``GenerationServer`` (plain kernel versions) and
its step loop; HTTP handler threads only enqueue and wait. ``/generate``
returns the tokens ``GenerationServer.run()`` serves for the same prompt,
concurrent requests all finish with their own ids, a sampled server
answers too, and ``/stats`` and ``/health`` answer; unknown paths are 404
and a malformed request a 400. Every wait has a timeout.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from flash_attention_from_scratch_tpu_torch.models.llama import LlamaConfig, init_params
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer
from flash_attention_from_scratch_tpu_torch.serving.http_server import ServingFrontend

CFG = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                  d_head=128, hidden_dim=256)
KW = dict(num_pages=32, page_size=64, max_batch=2, pages_per_seq=8, device="cpu")
TIMEOUT = 120


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(params=[{}, dict(temperature=0.8, top_k=20, seed=3)],
                ids=["greedy", "sampled"])
def frontend(request, params):
    fe = ServingFrontend(GenerationServer(params, CFG, **KW, **request.param))
    httpd = fe.make_http_server(port=0)  # an ephemeral loopback port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield fe, httpd.server_address[1], request.param
    httpd.shutdown()
    fe.shutdown()
    t.join(timeout=10)
    assert not t.is_alive() and not fe._loop.is_alive()


def _post(port, payload, path="/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def test_generate_returns_the_served_tokens(frontend, params):
    """A request's tokens are the ones ``run()`` serves for the same prompt
    under the same sequence id (sampling is keyed on it)."""
    fe, port, opts = frontend
    prompt = list(range(10, 40))
    got = _post(port, {"prompt": prompt, "max_new_tokens": 5})
    server = GenerationServer(params, CFG, **KW, **opts)
    server.submit(got["id"], prompt, 5)
    assert got["tokens"] == server.run()[got["id"]]


def test_concurrent_requests_all_finish(frontend):
    fe, port, _ = frontend
    results = {}

    def client(i):
        results[i] = _post(port, {"prompt": list(range(3 * i, 3 * i + 5 + i)),
                                  "max_new_tokens": 3 + i % 3})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(6))
    assert len({r["id"] for r in results.values()}) == 6
    for i, r in results.items():
        assert len(r["tokens"]) == 3 + i % 3
    assert not fe.server.seqs  # finished sequences are dropped


def test_stats_health_and_errors(frontend):
    fe, port, _ = frontend
    _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 2, "stop": [999]})
    status, stats = _get(port, "/stats")
    assert status == 200 and stats["decode_tokens"] >= 1
    assert {"running", "waiting", "pending_results", "prefix_hit_pages"} <= set(stats)
    assert _get(port, "/health") == (200, {"ok": True, "error": None})
    for call in (lambda: _get(port, "/nowhere"), lambda: _post(port, {}, "/nowhere")):
        with pytest.raises(urllib.error.HTTPError) as exc:
            call()
        assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, {"max_new_tokens": 2})  # no prompt
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, {"text": "hello"})  # no tokenizer attached
    assert exc.value.code == 400
