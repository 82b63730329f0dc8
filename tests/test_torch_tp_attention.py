"""Tensor- and data-parallel paged attention of the port
(``parallel/collectives.py``), on the CPU.

(a) The ACC-merge algebra, port against reference on the same numpy
    inputs (mirrors tests/test_tp_serving.py's three merge tests): the
    paged decode triplets over 2- and 4-way page splits, and the verify
    triplets over a 2-way split, merged by Eq. 16, match the unsplit
    call (the reference's bounds, 2e-5 fa2 and 0.05 hfa) and the
    reference's merge of its own splits (``JNP_ATOL``, the port-vs-jnp
    bound of test_torch_paged_codecs.py); per-head triplets padded with
    the neutral element and merged are bit-equal to the unsplit triplet
    (:func:`collectives.pad_neutral`, :func:`collectives.merge_shards`).
(b) Two gloo ranks (``launch/mesh.py``'s ``run_ranks``, one spawned)
    run ``shardmap_paged_attention`` in decode, verify and prefill mode
    on fp and int8 pools, both rails, ragged lengths and a free slot, on
    a tp 2 mesh and on a dp 2 mesh: each rank's output is bit-equal to
    the port's single-shard write + ``ops.paged_*_attention`` (what the
    model runs without a mesh), each rank's pools after the write equal
    its heads of the single-shard pools, and the output lies within
    ``JNP_ATOL`` of the reference's single-shard write + jnp attention
    on live rows.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import decode as jdec
from repro.kernels import ops as jops
from repro.kernels import page_codec as jcodec
from repro.kernels import paged_decode as jpd
from repro.kernels import paged_prefill as jpp
from repro_torch.kernels import decode as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import page_codec as tcodec
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import paged_prefill as tpp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import collectives
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# Finalized outputs, port against the reference's jnp path (as
# test_torch_paged_codecs.py holds them).
JNP_ATOL = {"fa2": 1e-5, "hfa": 1e-2}
# The reference's bound for a page-split merge against the unsplit call.
SPLIT_TOL = {"fa2": 2e-5, "hfa": 0.05}


# ------------------------------------------------------------------ (a)
def _pool_setup(seed=0, b=3, hkv=2, g=2, d=64, page=8, pps=4):
    """The reference's _pool_setup: random pools, a shuffled page table,
    ragged lengths with slot 0 free."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps
    kp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages).reshape(b, pps).astype(np.int32)
    kvl = np.asarray([0, 27, page * pps], np.int32)[:b]
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    return q, kp, vp, pt, kvl, page, pps


def _merge_both(parts_t, parts_j, use_hfa):
    """(port, reference) finalized merges of lists of triplets."""
    t = [torch.stack([p[i] for p in parts_t]) for i in range(3)]
    j = [jnp.stack([p[i] for p in parts_j]) for i in range(3)]
    to, _, tl = tdec.merge_partials(*t, use_hfa=use_hfa)
    jo, _, jl = jdec.merge_partials(*j, use_hfa=use_hfa)
    return (tdec.finalize_decode(to, tl, use_hfa=use_hfa).numpy(),
            np.asarray(jdec.finalize_decode(jo, jl, use_hfa=use_hfa)))


@pytest.mark.parametrize("use_hfa", [False, True])
@pytest.mark.parametrize("parts", [2, 4])
def test_merge_partials_page_splits_match_unsplit(use_hfa, parts):
    impl = "hfa" if use_hfa else "fa2"
    q, kp, vp, pt, kvl, page, pps = _pool_setup()
    b, _, h, d = q.shape
    qg = q.reshape(b, 2, h // 2, d)
    ref = tops.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, pt, kvl)), impl=impl).numpy()
    pp = pps // parts
    span = pp * page
    tparts, jparts = [], []
    for j in range(parts):
        kvl_j = np.clip(kvl - j * span, 0, span).astype(np.int32)
        args = (qg, kp, vp, np.ascontiguousarray(pt[:, j * pp:(j + 1) * pp]),
                kvl_j)
        tparts.append(tops.paged_decode_partials(
            *map(torch.from_numpy, args), impl=impl))
        jparts.append(jops.paged_decode_partials(
            *map(jnp.asarray, args), impl=impl))
    got, want = _merge_both(tparts, jparts, use_hfa)
    got = got.reshape(ref.shape)
    assert np.abs(got - ref).max() < SPLIT_TOL[impl]
    np.testing.assert_allclose(got, want.reshape(ref.shape),
                               atol=JNP_ATOL[impl], rtol=0)


@pytest.mark.parametrize("use_hfa", [False, True])
def test_merge_neutral_head_padding_is_exact(use_hfa):
    """One "shard" a KV head, padded with the neutral element and merged
    through the collectives' own pad and merge: bit-equal to the
    unsplit finalize (what makes KV-head-sharded serving token-exact);
    the reference's unsplit finalize within JNP_ATOL."""
    impl = "hfa" if use_hfa else "fa2"
    q, kp, vp, pt, kvl, _, _ = _pool_setup()
    b, _, h, d = q.shape
    qg = q.reshape(b, 2, h // 2, d)
    o, m, l = tops.paged_decode_partials(
        *map(torch.from_numpy, (qg, kp, vp, pt, kvl)), impl=impl)
    hkv = o.shape[1]
    packed = torch.stack([
        collectives.pad_neutral(o[:, hs], m[:, hs], l[:, hs], hkv, hs)
        for hs in (collectives.head_slice(hkv, hkv, s) for s in range(hkv))])
    got = collectives.merge_shards(packed, use_hfa=use_hfa)
    want = tdec.finalize_decode(o, l, use_hfa=use_hfa)
    assert torch.equal(got, want)
    jo, _, jl = jops.paged_decode_partials(
        *map(jnp.asarray, (qg, kp, vp, pt, kvl)), impl=impl)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdec.finalize_decode(jo, jl,
                                                     use_hfa=use_hfa)),
        atol=JNP_ATOL[impl], rtol=0)


@pytest.mark.parametrize("use_hfa", [False, True])
def test_merge_partials_verify_page_splits(use_hfa):
    impl = "hfa" if use_hfa else "fa2"
    rng = np.random.default_rng(1)
    b, hkv, g, d, page, pps, kw = 2, 2, 2, 64, 8, 4, 3
    num_pages = b * pps
    kp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages).reshape(b, pps).astype(np.int32)
    sl = np.asarray([9, 20], np.int32)
    cl = np.asarray([kw, kw], np.int32)
    q = rng.standard_normal((b, kw, hkv * g, d)).astype(np.float32)
    qg = np.ascontiguousarray(
        np.swapaxes(q, 1, 2).reshape(b, hkv, g, kw, d))
    ref = tops.paged_verify_attention(
        *map(torch.from_numpy, (q, kp, vp, pt, sl, cl)), impl=impl).numpy()
    span = (pps // 2) * page
    tparts, jparts = [], []
    for j in range(2):
        sl_j = np.clip(sl - j * span, 0, span).astype(np.int32)
        cl_j = (np.clip(sl + cl - j * span, 0, span) - sl_j).astype(np.int32)
        args = (qg, kp, vp,
                np.ascontiguousarray(pt[:, j * (pps // 2):(j + 1) *
                                        (pps // 2)]), sl_j, cl_j)
        tparts.append(tops.paged_verify_partials(
            *map(torch.from_numpy, args), impl=impl))
        jparts.append(jops.paged_verify_partials(
            *map(jnp.asarray, args), impl=impl))
    got, want = _merge_both(tparts, jparts, use_hfa)
    got = np.swapaxes(got.reshape(b, hkv * g, kw, d), 1, 2)
    want = np.swapaxes(want.reshape(b, hkv * g, kw, d), 1, 2)
    assert np.abs(got - ref).max() < SPLIT_TOL[impl]
    np.testing.assert_allclose(got, want, atol=JNP_ATOL[impl], rtol=0)


# ------------------------------------------------------------------ (b)
B, HKV, G, D, PAGE, PPS = 4, 2, 2, 64, 8, 4
MODES = ("decode", "verify", "prefill")
CODECS = ("fp", "int8")
RAILS = ("fa2", "hfa")
MESHES = ((2, 1), (1, 2))
# (lens_a, lens_b, rows a slot): slot 0 free, the others ragged.
LENS = {"decode": ([0, 13, 31, 20], [0, 0, 0, 0], 1),
        "verify": ([0, 9, 20, 4], [0, 3, 2, 3], 3),
        "prefill": ([0, 6, 0, 12], [0, 5, 3, 2], 5)}


def _attention_case(mode, codec, seed):
    """numpy inputs of one call: full-width pools (encoded by ``codec``),
    q, this step's K/V, the page table and the lengths."""
    rng = np.random.default_rng(seed)
    num_pages = B * PPS + 2
    pools = {}
    cod = tcodec.get_codec(codec)
    for key in ("k", "v"):
        raw = torch.from_numpy(rng.standard_normal(
            (num_pages, PAGE, HKV, D)).astype(np.float32))
        data, scale = cod.encode(raw)
        pools[f"{key}_pages"] = data.numpy()
        if cod.has_scales:
            pools[f"{key}_scale"] = scale.numpy()
    la, lb, ell = LENS[mode]
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"mode": mode, "codec": codec,
            "pools": pools, "q": f32(B, ell, HKV * G, D),
            "k_new": f32(B, ell, HKV, D), "v_new": f32(B, ell, HKV, D),
            "page_table": rng.permutation(num_pages)[:B * PPS].reshape(
                B, PPS).astype(np.int32),
            "lens_a": np.asarray(la, np.int32),
            "lens_b": np.asarray(lb, np.int32)}


def _jobs():
    """One job a (mesh, mode, codec, rail); both meshes see the same
    inputs."""
    jobs = []
    for mesh in MESHES:
        for i, (mode, codec, rail) in enumerate(
                itertools.product(MODES, CODECS, RAILS)):
            job = _attention_case(mode, codec, seed=100 + i)
            job.update(impl=rail, mesh=mesh)
            jobs.append(job)
    return jobs


def _single(job):
    """The port's single-shard write and attention (the model's path
    without a mesh): (out, pools) as numpy."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in job.items()
         if isinstance(v, np.ndarray)}
    pools = {k: torch.from_numpy(v.copy()) for k, v in job["pools"].items()}
    cod = tcodec.get_codec(job["codec"])
    la, lb, pt = t["lens_a"], t["lens_b"], t["page_table"]
    if job["mode"] == "decode":
        pools = tcodec.encode_write(tpd.append_kv, cod, pools, t["k_new"],
                                    t["v_new"], pt, la)
    else:
        pools = tcodec.encode_write(tpp.write_chunk_kv, cod, pools,
                                    t["k_new"], t["v_new"], pt, la, lb)
    read = dict(impl=job["impl"], codec=None if cod.name == "fp" else cod,
                k_scales=pools.get("k_scale"), v_scales=pools.get("v_scale"))
    kp, vp = pools["k_pages"], pools["v_pages"]
    if job["mode"] == "decode":
        out = tops.paged_decode_attention(
            t["q"], kp, vp, pt, torch.where(la > 0, la + 1, 0), **read)
    elif job["mode"] == "verify":
        out = tops.paged_verify_attention(t["q"], kp, vp, pt, la, lb, **read)
    else:
        out = tops.paged_prefill_attention(t["q"], kp, vp, pt, la, lb,
                                           **read)
    return out.numpy(), {k: v.numpy() for k, v in pools.items()}


_REFERENCE: dict = {}


def _reference(job):
    """The reference's single-shard write and jnp attention (once a
    mode, codec and rail: both meshes' jobs share the inputs)."""
    key = (job["mode"], job["codec"], job["impl"])
    if key not in _REFERENCE:
        _REFERENCE[key] = _reference_call(job)
    return _REFERENCE[key]


def _reference_call(job):
    j = {k: jnp.asarray(v) for k, v in job.items()
         if isinstance(v, np.ndarray)}
    pools = {k: jnp.asarray(v) for k, v in job["pools"].items()}
    cod = jcodec.get_codec(job["codec"])
    la, lb, pt = j["lens_a"], j["lens_b"], j["page_table"]
    if job["mode"] == "decode":
        pools = jcodec.encode_write(jpd.append_kv, cod, pools, j["k_new"],
                                    j["v_new"], pt, la)
    else:
        pools = jcodec.encode_write(jpp.write_chunk_kv, cod, pools,
                                    j["k_new"], j["v_new"], pt, la, lb)
    read = dict(impl=job["impl"], codec=None if cod.name == "fp" else cod,
                k_scales=pools.get("k_scale"), v_scales=pools.get("v_scale"))
    kp, vp = pools["k_pages"], pools["v_pages"]
    if job["mode"] == "decode":
        out = jops.paged_decode_attention(j["q"], kp, vp, pt,
                                          jnp.where(la > 0, la + 1, 0),
                                          **read)
    elif job["mode"] == "verify":
        out = jops.paged_verify_attention(j["q"], kp, vp, pt, la, lb, **read)
    else:
        out = jops.paged_prefill_attention(j["q"], kp, vp, pt, la, lb,
                                           **read)
    return np.asarray(out)


def _live(job):
    """(B, L) mask of the rows a caller reads."""
    la, lb, ell = LENS[job["mode"]]
    if job["mode"] == "decode":
        return np.asarray(la)[:, None] > 0
    return np.arange(ell)[None] < np.asarray(lb)[:, None]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _attention_job(mesh, job: dict) -> dict:
    """One ``shardmap_paged_attention`` call on this rank over its heads
    of the job's full-width inputs; its output and its pools after the
    write, as numpy."""
    def t(a):
        return torch.from_numpy(np.asarray(a))

    full = {k: t(v) for k, v in job["pools"].items()}
    pools = collectives.shard_pools(full, collectives.tp_shards(mesh),
                                    mesh.model_index)
    out, pools = collectives.shardmap_paged_attention(
        t(job["q"]), t(job["k_new"]), t(job["v_new"]), pools,
        t(job["page_table"]), t(job["lens_a"]), t(job["lens_b"]),
        mesh=mesh, mode=job["mode"], impl=job["impl"], codec=job["codec"])
    return {"out": _to_numpy(out),
            "pools": {k: _to_numpy(v) for k, v in pools.items()}}


def _run_jobs(jobs: list) -> list:
    """Every job on this rank, each on its (tp, dp) mesh, made once and
    in job order on every rank (the spawned rank imports this module
    by name to run it)."""
    meshes, out = {}, []
    for job in jobs:
        if job["mesh"] not in meshes:
            meshes[job["mesh"]] = mesh_lib.make_tp_dp_mesh(
                *job["mesh"], device="cpu")
        out.append(_attention_job(meshes[job["mesh"]], job))
    return out


@pytest.fixture(scope="module")
def two_ranks():
    """Every job on two gloo ranks: [(job, [rank 0's result, rank 1's])]."""
    jobs = _jobs()
    mine, (theirs,) = mesh_lib.run_ranks(
        lambda: _run_jobs(jobs), _run_jobs, 2, args=(jobs,), device="cpu",
        timeout=300)
    return [(job, [a, b]) for job, a, b in zip(jobs, mine, theirs)]


def _job_ids():
    return [f"{m[0]}x{m[1]}-{mode}-{codec}-{rail}" for m in MESHES
            for mode in MODES for codec in CODECS for rail in RAILS]


@pytest.mark.parametrize("index", range(len(_job_ids())), ids=_job_ids())
def test_sharded_attention_on_two_ranks(two_ranks, index):
    job, results = two_ranks[index]
    want, want_pools = _single(job)
    tp = job["mesh"][0]
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["out"], want, err_msg=f"rank {rank}")
        heads = collectives.head_slice(HKV, tp, rank % tp)
        for key, pool in res["pools"].items():
            np.testing.assert_array_equal(pool, want_pools[key][:, :, heads],
                                          err_msg=f"rank {rank} {key}")
    live = _live(job)
    np.testing.assert_allclose(results[0]["out"][live],
                               _reference(job)[live],
                               atol=JNP_ATOL[job["impl"]], rtol=0)
