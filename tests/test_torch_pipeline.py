"""The batched encode + scrub step of the port (seaweedfs_tpu_torch/
models/ec_pipeline.py) against the reference's jitted step under JAX on
the CPU, on the same seeded numpy stripes. Tolerance 0 (integer GF(256)
arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import ec_pipeline as ref_pipeline
from seaweedfs_tpu_torch.models import ec_pipeline as port_pipeline
from seaweedfs_tpu_torch.ops import codec_numpy, rs_matrix


@pytest.mark.parametrize("k,m", [(10, 4), (28, 4)])
def test_parity_bit_matrix(k, m):
    assert np.array_equal(port_pipeline.parity_bit_matrix(k, m),
                          ref_pipeline.parity_bit_matrix(k, m))


@pytest.mark.parametrize("k,m,batch,n", [(10, 4, 3, 777), (28, 4, 2, 64),
                                         (10, 4, 1, 1)])
def test_encode_batch_matches_reference(k, m, batch, n):
    rng = np.random.default_rng(batch * n)
    stripes = rng.integers(0, 256, (batch, k, n), dtype=np.uint8)
    a_bits = port_pipeline.parity_bit_matrix(k, m)
    want = np.asarray(ref_pipeline.encode_batch(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(stripes)))
    got = port_pipeline.encode_batch(a_bits, stripes, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (batch, m, n)
    assert np.array_equal(got.numpy(), want)


def test_encode_batch_chunks_the_expansion(monkeypatch):
    monkeypatch.setattr(port_pipeline, "_EXPANSION_BYTES", 1)
    rng = np.random.default_rng(2)
    stripes = rng.integers(0, 256, (5, 10, 300), dtype=np.uint8)
    got = port_pipeline.encode_batch(port_pipeline.parity_bit_matrix(),
                                     torch.from_numpy(stripes),
                                     device="cpu")
    coef = rs_matrix.parity_rows(10, 4)
    for b in range(5):
        assert np.array_equal(got[b].numpy(),
                              codec_numpy.coded_matmul(coef, stripes[b]))


def test_scrub_counts_mismatches():
    rng = np.random.default_rng(9)
    stripes = rng.integers(0, 256, (4, 10, 500), dtype=np.uint8)
    a_bits = port_pipeline.parity_bit_matrix()
    coef = rs_matrix.parity_rows(10, 4)
    expected = np.stack([codec_numpy.coded_matmul(coef, s) for s in stripes])
    parity, mism = port_pipeline.encode_scrub_step(a_bits, stripes,
                                                   expected, device="cpu")
    _, ref_mism = ref_pipeline.encode_scrub_step(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(stripes),
        jnp.asarray(expected))
    assert int(mism) == int(ref_mism) == 0
    assert np.array_equal(parity.numpy(), expected)
    expected[2, 1, 123] ^= 0x01
    _, mism = port_pipeline.encode_scrub_step(a_bits, stripes, expected,
                                              device="cpu")
    _, ref_mism = ref_pipeline.encode_scrub_step(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(stripes),
        jnp.asarray(expected))
    assert int(mism) == int(ref_mism) == 1


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stripes = np.zeros((1, 10, 8), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipeline.encode_batch(port_pipeline.parity_bit_matrix(),
                                   stripes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipeline.encode_scrub_step(port_pipeline.parity_bit_matrix(),
                                        stripes, stripes[:, :4])


@pytest.mark.parametrize("k,m", [(10, 4), (28, 4)])
def test_jitted_encode_matches_reference(k, m):
    rng = np.random.default_rng(k)
    stripes = rng.integers(0, 256, (2, k, 999), dtype=np.uint8)
    fn, a_bits = port_pipeline.jitted_encode(k, m, device="cpu")
    ref_fn, ref_a = ref_pipeline.jitted_encode(k, m)
    assert a_bits.dtype == torch.float32
    assert np.array_equal(a_bits.numpy(), np.asarray(ref_a, np.float32))
    assert np.array_equal(fn(a_bits, stripes).numpy(),
                          np.asarray(ref_fn(ref_a, stripes)))


def test_staged_feed_keeps_order_and_labels_its_stages():
    """Blocks whose uploads and drains finish out of order come back in
    input order, with pread and relay observed once per block under the
    feed's label, at every depth."""
    import random
    import time

    from seaweedfs_tpu_torch.utils import metrics

    def upload(i):
        time.sleep(random.Random(i).random() / 500)
        return i * 10

    def drain(fut):
        v = fut.result()
        time.sleep(random.Random(v).random() / 500)
        return v + 1, time.perf_counter()

    for depth in (1, 2, 4):
        label = f"test-feed-{depth}"
        out = list(port_pipeline._staged_feed(iter(range(9)), upload, drain,
                                              depth, label))
        assert out == [i * 10 + 1 for i in range(9)]
        for stage in ("pread", "relay"):
            assert metrics.counter_value(
                "ec_codec_stage_seconds_count",
                {"stage": stage, "backend": label}) == 9


@pytest.mark.parametrize("feed", ["ec_pipeline", "ec_scrub"])
def test_feed_stage_labels(feed):
    """Each feed records pread, h2d, kernel, d2h and relay under the
    reference's label, once per block."""
    from seaweedfs_tpu_torch.utils import metrics

    rng = np.random.default_rng(4)
    blocks = [rng.integers(0, 256, (2, 10, 100), dtype=np.uint8)
              for _ in range(3)]

    def count(stage):
        return metrics.counter_value("ec_codec_stage_seconds_count",
                                     {"stage": stage, "backend": feed})

    before = {s: count(s) for s in ("pread", "h2d", "kernel", "d2h",
                                    "relay")}
    if feed == "ec_pipeline":
        list(port_pipeline.pipelined_encode_stream(iter(blocks),
                                                   device="cpu"))
    else:
        fn, a = port_pipeline.jitted_encode(device="cpu")
        assert port_pipeline.pipelined_scrub(
            iter([(b, fn(a, b).numpy()) for b in blocks]),
            device="cpu") == (0, 3)
    assert {s: count(s) - before[s] for s in before} == \
        dict.fromkeys(before, 3)


def test_feeds_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    block = np.zeros((1, 10, 8), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(port_pipeline.pipelined_encode_stream(iter([block])))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipeline.pipelined_scrub(iter([(block, block[:, :4])]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipeline.jitted_encode()
