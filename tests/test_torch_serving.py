"""The serving slice as a whole: the same encoder parameters, images and
gallery go through the JAX QueryEngine / ServingPipeline (Pallas kernels in
interpret mode) and through the port (plain versions on the CPU), and give
the same neighbours at the same distances. Then the port's HTTP server
answers on an ephemeral port as its engine does."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hashgan_tpu.index import QueryEngine as JaxEngine
from hashgan_tpu.index import ServingPipeline as JaxPipeline
from hashgan_tpu.index.gallery import build_gallery_from_packed as jax_build
from hashgan_tpu.models.encoders import SmallCNNEncoder as FlaxEncoder
from hashgan_tpu.ops.pack import pack_codes_jnp
from hashgan_tpu.ops.ref_numpy import pack_codes_np
from hashgan_tpu_torch.index import (
    QueryEngine,
    ServingPipeline,
    build_gallery_from_packed,
    make_server,
)
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.ops.pack import pack_codes

from torch_threads import one_thread  # noqa: F401

BITS, N, K = 32, 700, 10


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(0)
    f_enc = FlaxEncoder(bits=BITS, dim=8)
    params = jax.device_get(f_enc.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)["params"])
    t_enc = SmallCNNEncoder(bits=BITS, dim=8)
    t_enc.load_state_dict(flax_to_torch(params))
    codes = np.where(rng.uniform(size=(N, BITS)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, N)]
    packed = pack_codes_np(codes)
    jax_engine = JaxEngine(f_enc, params, jax_build(packed, labels, BITS))
    port = QueryEngine(t_enc, build_gallery_from_packed(
        packed, labels, BITS, device="cpu"))
    batches = [rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
               for _ in range(3)]
    return jax_engine, port, codes, batches


def test_pipeline_matches_jax_pipeline(engines):
    jax_engine, port, _, batches = engines
    # Precondition: both encoders pack these images to the same query words
    # (a code within float32 rounding of 0 would flip one bit).
    for b in batches:
        np.testing.assert_array_equal(
            pack_codes(port.encode(b)).numpy().view(np.uint32),
            np.asarray(pack_codes_jnp(jax_engine.encode(b))))
    want = list(JaxPipeline(jax_engine, k=K, interpret=True).map_batches(batches))
    got = list(ServingPipeline(port, k=K, depth=2).map_batches(batches))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.distances, w.distances)
        assert g.indices.dtype == np.int32 and g.indices.shape == (8, K)


def test_query_engine_matches_jax_engine(engines):
    jax_engine, port, codes, batches = engines
    imgs = batches[0]
    g = port.query_images(imgs, k=K, with_labels=True)
    w = jax_engine.query_images(imgs, k=K, with_labels=True)
    np.testing.assert_array_equal(g.indices, w.indices)
    np.testing.assert_array_equal(g.distances, w.distances)
    np.testing.assert_array_equal(g.labels, w.labels)
    # a code-only engine over a 50-item gallery, queried at k > n: sentinels
    n = 50
    packed, labels = pack_codes_np(codes[:n]), port.gallery.labels[:n]
    small_port = QueryEngine(None, build_gallery_from_packed(
        packed, labels, BITS, device="cpu"))
    small_jax = JaxEngine(None, None, jax_build(packed, labels, BITS))
    q = codes[:5] + np.random.default_rng(1).normal(0, 0.1, (5, BITS))
    g = small_port.query_codes(q, k=n + 20, with_labels=True)
    w = small_jax.query_codes(jnp.asarray(q, jnp.float32), k=n + 20,
                              with_labels=True)
    np.testing.assert_array_equal(g.indices[:, :n], w.indices[:, :n])
    np.testing.assert_array_equal(g.distances[:, :n], w.distances[:, :n])
    assert (g.indices[:, n:] >= n).all() and (g.labels[:, n:] == 0).all()
    assert [r[0] for r in g.indices] == [0, 1, 2, 3, 4]


def test_pipeline_refuses_what_is_not_ported(engines):
    """k past 256 (the large-k engine) and approx mode are served as the
    JAX pipeline serves them; what the reference's pipeline refuses (no
    encoder, no grouped layout, an unknown mode) is refused here too."""
    jax_engine, port, _, batches = engines
    for k in (300, 1000):
        want = JaxPipeline(jax_engine, k=k, interpret=True).map_batches(
            batches[:1])
        got = ServingPipeline(port, k=k).map_batches(batches[:1])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.indices, w.indices)
            np.testing.assert_array_equal(g.distances, w.distances)
    for k in (10, 300):
        want = next(JaxPipeline(jax_engine, k=k, mode="approx",
                                interpret=True).map_batches(batches[:1]))
        got = next(ServingPipeline(port, k=k, mode="approx").map_batches(
            batches[:1]))
        np.testing.assert_array_equal(got.distances, want.distances)
        real = got.indices < N  # past the valid subgroups: sentinels
        assert got.indices.shape == (8, k) and real[:, :10].all()
        assert (got.distances[~real] == BITS + 1).all()
    with pytest.raises(ValueError, match="needs an encoder"):
        ServingPipeline(QueryEngine(None, port.gallery))
    with pytest.raises(ValueError, match="mode"):
        ServingPipeline(port, mode="fast")
    ungrouped = dataclasses.replace(port.gallery, gallery_grouped=None,
                                    canon_bg=None)
    with pytest.raises(ValueError, match="grouped layout"):
        ServingPipeline(QueryEngine(port.encoder, ungrouped))


def _req(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    r = urllib.request.Request(base + path, data=data,
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_server_answers_like_the_engine(engines):
    jax_engine, port, codes, batches = engines
    engine = QueryEngine(port.encoder, port.gallery)  # its own gallery swaps
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        h = _req(base, "/healthz")
        assert h == {"status": "ok", "n": N, "bits": BITS, "has_encoder": True}
        out = _req(base, "/query", {"images": batches[1][:2].tolist(), "k": 5})
        ref = jax_engine.query_images(batches[1][:2], k=5)
        np.testing.assert_array_equal(out["indices"], ref.indices)
        np.testing.assert_array_equal(out["distances"], ref.distances)
        out = _req(base, "/query", {"codes": codes[:3].tolist(), "k": 4})
        assert [r[0] for r in out["indices"]] == [0, 1, 2]

        new = np.where(np.random.default_rng(3).uniform(size=(5, BITS)) < 0.5,
                       -1.0, 1.0)
        assert _req(base, "/extend", {"codes": new.tolist(),
                                      "labels": np.zeros((5, 4)).tolist()}
                    ) == {"n": N + 5}
        out = _req(base, "/query", {"codes": new.tolist(), "k": 1})
        assert [r[0] for r in out["indices"]] == list(range(N, N + 5))
        assert all(r[0] == 0 for r in out["distances"])
        out = _req(base, "/remove", {"ids": [N, N + 1]})
        assert out["n"] == N + 3 and out["id_map"][N:] == [N + 2, N + 3, N + 4]
        for payload in ({"codes": codes[:2].tolist(), "k": 300},
                        {"codes": codes[:2].tolist(), "mode": "approx"}):
            out = _req(base, "/query", payload)
            ref = engine.query_codes(codes[:2], k=payload.get("k", 100),
                                     mode=payload.get("mode", "exact"))
            np.testing.assert_array_equal(out["indices"], ref.indices)
            np.testing.assert_array_equal(out["distances"], ref.distances)
        assert len(out["indices"][0]) == 100
        for payload, frag in (
            ({"codes": [[1.0, 2.0]]}, "codes must be"),
            ({"k": 5}, "needs 'codes' or 'images'"),
            ({"codes": codes[:1].tolist(), "mode": "nope"}, "unknown mode"),
        ):
            with pytest.raises(urllib.error.HTTPError) as e:
                _req(base, "/query", payload)
            assert e.value.code == 400
            assert frag in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, "/remove", {"ids": [-1]})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, "/nope", {})
        assert e.value.code == 404
        stats = _req(base, "/stats")
        assert stats["requests"]["/query"] == 8
        assert stats["errors"]["/query"] == 3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_cli_query_matches_jax_cli(engines, tmp_path, capsys, monkeypatch):
    import torch

    from hashgan_tpu import cli as jax_cli
    from hashgan_tpu_torch import cli

    _, port, _, _ = engines
    path = str(tmp_path / "gallery.npz")
    port.gallery.save(path)
    args = ["query", "--gallery", path, "--k", "7", "--n-queries", "3"]
    jax_cli.main(args)
    want = capsys.readouterr().out.splitlines()
    # The CLI serves from a GPU only; here the gallery loads to the CPU.
    monkeypatch.setattr(cli, "_device", lambda gpu: torch.device("cpu"))
    cli.main(args)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == 3 and got == want
