"""The port's page codecs (``repro_torch/kernels/page_codec.py``) against
the reference's (``src/repro/kernels/page_codec.py``).

* encode is bit-exact: the same numpy values, as f32 and as bf16, with an
  all-zero token row and bf16 subnormals, give the reference's int8 data
  and f32 scales and its log16 bits (the port stores log16's uint16
  patterns as int16: torch has no index_put for uint16);
* the round-trip contract of the reference's test_page_codec_roundtrip:
  fp the identity, int8 within half a step with zero rows exact, log16
  equal to a bf16 cast;
* log16 of a bf16 tensor stores exactly its bits, over every finite bf16
  pattern - which is why a log16 pool at bf16 compute reads as a bf16
  pool;
* byte accounting: ``bytes_per_token`` (int8 d + 4 a row, log16 2 d)
  equals the reference's, and the pools ``stack_init_paged_cache``
  allocates - the f32 scale sidecars included - hold exactly that, as in
  test_page_codec_pool_byte_accounting.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.kernels import page_codec as jcodec
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.kernels import page_codec
from repro_torch.models import transformer

CODECS = ["fp", "int8", "log16"]


def _values(seed):
    x = np.random.default_rng(seed).standard_normal((3, 8, 2, 64)).astype(
        np.float32)
    x[1, 2] = 0.0                                    # an all-zero token row
    x[2, 5, 1, :16] = np.float32(3e-39)              # subnormals (bf16 too)
    x[0, 1, 0, :4] = [-0.0, 1e-38, -2e-39, 65504.0]
    return x


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["int8", "log16"])
def test_encode_bit_exact_to_reference(name, dtype):
    x = _values(7)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if dtype == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    td, ts = page_codec.get_codec(name).encode(xt)
    jd, js = jcodec.get_codec(name).encode(xj)
    np.testing.assert_array_equal(td.numpy(), _bits(np.asarray(jd)))
    assert td.dtype == {"int8": torch.int8, "log16": torch.int16}[name]
    if name == "int8":
        assert ts.dtype == torch.float32 and ts.shape == x.shape[:-1] + (1,)
        np.testing.assert_array_equal(_bits(ts.numpy()),
                                      _bits(np.asarray(js)))
    else:
        assert ts is None and js is None


@pytest.mark.parametrize("name", CODECS)
def test_roundtrip_contract(name):
    """As the reference's test_page_codec_roundtrip, and the decode equal
    to the reference's decode of the reference's encoding."""
    x = _values(301)
    c = page_codec.get_codec(name)
    data, scales = c.encode(torch.from_numpy(x))
    y = c.decode(data, scales).numpy()
    jc = jcodec.get_codec(name)
    np.testing.assert_array_equal(y, np.asarray(jc.decode(*jc.encode(
        jnp.asarray(x)))))
    if name == "fp":
        assert scales is None
        np.testing.assert_array_equal(y, x)
    elif name == "int8":
        err = np.abs(y - x)
        bound = 0.5 * scales.numpy() * (1 + 1e-5) + 1e-7
        assert (err <= bound).all(), float((err - bound).max())
        np.testing.assert_array_equal(y[1, 2], 0.0)
    else:
        ref = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(y, ref)


def test_log16_of_bf16_stores_its_bits():
    bits = torch.arange(1 << 16, dtype=torch.int32)
    x = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(
        torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x.float())]
    data, _ = page_codec.get_codec("log16").encode(x)
    assert torch.equal(data, x.view(torch.int16))
    assert torch.equal(page_codec.decode_pages("log16", data, None),
                       x.float())


@pytest.mark.parametrize("name", CODECS)
def test_pool_byte_accounting(name):
    cfg = get_config("qwen3-1.7b").reduced()
    num_pages, page = 6, 8
    layers = transformer.stack_init_paged_cache(cfg, num_pages, page,
                                                torch.float32, "cpu",
                                                codec=name)
    total = sum(t.numel() * t.element_size() for d in layers.values()
                for t in d.values())
    per_token = page_codec.bytes_per_token(name, cfg.n_kv_heads, cfg.d_head,
                                           torch.float32)
    assert per_token == jcodec.bytes_per_token(name, cfg.n_kv_heads,
                                               cfg.d_head, jnp.float32)
    assert per_token == 2 * cfg.n_kv_heads * {
        "fp": 4 * cfg.d_head, "int8": cfg.d_head + 4,
        "log16": 2 * cfg.d_head}[name]
    assert total == cfg.n_layers * num_pages * page * per_token
    jlayers = jtransformer.stack_init_paged_cache(
        jget_config("qwen3-1.7b").reduced(), num_pages, page, jnp.float32,
        codec=name)
    assert total == sum(int(a.nbytes) for d in jlayers.values()
                        for a in d.values())
    want = {"k_pages", "v_pages"} | (
        {"k_scale", "v_scale"} if name == "int8" else set())
    for d in layers.values():
        assert set(d) == want
        if name == "int8":
            assert d["k_scale"].shape == d["k_pages"].shape[:-1] + (1,)
            assert d["k_scale"].dtype == torch.float32


def test_unknown_codec_is_refused():
    with pytest.raises(ValueError, match="unknown page codec"):
        page_codec.get_codec("fp8")
    c = page_codec.get_codec("int8")
    assert page_codec.get_codec(c) is c and page_codec.get_codec(None).name \
        == "fp"
