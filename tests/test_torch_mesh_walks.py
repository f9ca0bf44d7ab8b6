"""The port's routed and grouped mesh walks (``parallel/sharded.py``'s
``sharded_extend_walks``, ``group_state`` and ``grouped_extend_walks``,
``graph/engine.py``'s ``RNB_MESH_WALK`` dispatch, ``graph/traverse.py``'s
backends and speculative supersteps) against the JAX package on the
8-device CPU mesh of ``tests/conftest.py``; the port's mesh is 8 shards on
the CPU device, where the walks run the plain lockstep loop over routed
reads.

The walk case, its graph and its golden digests are
``tests/test_torch_mesh.py``'s: the JAX package's single-device walks
wrote ``tests/golden/mesh_walks.json``, and its own routed and grouped
walks give them too (``test_jax_routed_and_grouped_walks_give_the_golden``,
slow; ``tests/test_sharded.py`` holds them to its single-device walks).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg, engine as jeng, traverse as jtr
from rnabloom_tpu.parallel import sharded as jsh
from rnabloom_tpu_torch.assembly import pipeline
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg, engine as teng, traverse as ttr
from rnabloom_tpu_torch.ops import nthash
from rnabloom_tpu_torch.parallel import sharded as tsh
from test_torch_mesh import (K, N, WALK_FIELDS, WALK_MODES, WALKS_GOLDEN, _digests, _mesh, _pairs, _tree,
                             _walk_case, _walk_configs, _walk_fields, _walk_rows)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def walk_graphs():
    """The walk case's graph built by the port on one device, the same
    filters on the port's 8-shard mesh, and the golden digests."""
    allreads, reads, seeds, greedy, lens = _walk_case()
    cj, ct = _walk_configs()
    gt = tdbg.make_graph(ct, with_rpkbf=True, with_fpkbf=True, device="cpu")
    gt = tdbg.rebuild_step(tdbg.build_step(gt, ct, torch.from_numpy(allreads), add_read_pairs=True), ct,
                           torch.from_numpy(allreads))
    with open(WALKS_GOLDEN) as f:
        golden = json.load(f)
    return dict(cj=cj, ct=ct, gt=gt, mt=teng.from_host_state(gt, ct, _mesh()), reads=reads, seeds=seeds,
                greedy=greedy, lens=lens, golden=golden)


def _jax_graph(gt) -> jdbg.GraphState:
    """The port's single-device filters as a JAX GraphState."""
    return jdbg.GraphState(*(None if t is None else jnp.asarray(t.numpy()) for t in gt))


# (RNB_MESH_WALK, RNB_MESH_GROUP, mode): every mode routed and grouped at the
# default R = 2, and naive walks grouped at R = 4
GOLDEN_CASES = [(env, None, mode) for env in ("routed", "grouped") for mode in WALK_MODES] + [
    ("grouped", "4", "naive")]


@pytest.mark.parametrize("walk_env,group,mode", GOLDEN_CASES,
                         ids=[f"{e}{g or ''}-{m}" for e, g, m in GOLDEN_CASES])
def test_routed_and_grouped_walks_give_the_golden_digests(walk_graphs, monkeypatch, walk_env, group, mode):
    """engine.extend_walks on the 8-shard mesh under RNB_MESH_WALK=routed and
    grouped: every field of every lane has the golden digest (the JAX
    package's single-device walk), through routed reads (all-to-alls and
    all-reduces counted), at the mesh walks' speculative depth 2 (naive
    walks check back branches: one hop a round)."""
    g = walk_graphs
    monkeypatch.setenv("RNB_MESH_WALK", walk_env)
    if group:
        monkeypatch.setenv("RNB_MESH_GROUP", group)
    else:
        monkeypatch.delenv("RNB_MESH_GROUP", raising=False)
    kw, bound = WALK_MODES[mode]
    rows, lens = _walk_rows(g, mode)
    wt = ttr.WalkConfig(**kw)
    with tsh.comm_accounting() as comm:
        got = teng.extend_walks(ttr.make_walks(g["ct"], wt, rows, lens, device="cpu"), g["mt"], g["ct"], wt,
                                np.float32(1.0), bound, mode=mode)
    assert _digests(got, _walk_fields(mode)) == g["golden"][mode]["digests"]
    assert comm["all_to_all"] > 0 and comm["psum"] > 0
    assert np.bincount(got.status.numpy(), minlength=7).tolist() == g["golden"][mode]["statuses"]
    if walk_env == "grouped":
        r = int(group or 2)
        states = g["mt"]._groups[r][1]
        assert len(states) == N // r and all(s is states[0] for s in states)  # one copy on the CPU device
        assert all(t.numel() == (1 << 18) // r + 1 for t in states[0].cbf)


@pytest.mark.parametrize("max_hops,term", [(7, False), (6, True)], ids=["odd_hops", "even_hops_terminators"])
def test_spec_superstep_equals_jax_and_one_hop_rounds(walk_graphs, max_hops, term):
    """walk_superstep at spec_hops = 2 equals the JAX package's on one state
    (the greedy case's seeds: long lanes, and lanes that fill their
    buffer), with and without terminators (the k-mers of every 7th read),
    and equals spec_hops = 1 at max_hops rounded up to a multiple of 2."""
    g = walk_graphs
    ct, cj = g["ct"], g["cj"]
    tcfg = tf.BloomConfig(16, 2)
    lanes = None
    if term:
        lanes = tf.make_bloom(tcfg, device="cpu")
        fh, rh, valid = nthash.rolling_hash(torch.from_numpy(g["reads"][::7]), K, False)
        tf.bloom_add(lanes, tcfg, nthash.multi_hash(nthash.canonical(fh, rh), K, 2), valid)
    kw = dict(WALK_MODES["greedy"][0], use_terminators=term)
    wt = ttr.WalkConfig(**kw, term_cfg=tcfg if term else None, spec_hops=2)
    wj = jtr.WalkConfig(**kw, term_cfg=jf.BloomConfig(16, 2) if term else None, spec_hops=2)
    rows, lens = g["greedy"], g["lens"]
    rng = np.random.default_rng(17)
    W = ttr.make_walks(ct, wt, rows, lens, device="cpu").pos.shape[0]
    min_cov = rng.choice([1.0, 2.0, 3.5], size=W).astype(np.float32)
    bound = rng.integers(3, 60, size=W).astype(np.int32)
    st = ttr.make_walks(ct, wt, rows, lens, device="cpu")
    mc, bd = ttr.lane_args(st, min_cov, bound)
    # the first superstep from the seeds, then one from where it stopped
    spec = ttr.walk_superstep(ttr.clone_state(st), g["gt"], ct, wt, mc, bd, max_hops, lanes)
    again = ttr.walk_superstep(ttr.clone_state(spec), g["gt"], ct, wt, mc, bd, max_hops, lanes)
    one_hop = ttr.WalkConfig(**kw, term_cfg=tcfg if term else None)
    want1 = ttr.walk_superstep(ttr.clone_state(st), g["gt"], ct, one_hop, mc, bd, -(-max_hops // 2) * 2, lanes)
    js = jtr.walk_superstep(jtr.make_walks(cj, wj, rows, lens), _jax_graph(g["gt"]), cj, wj, jnp.asarray(min_cov),
                            jnp.asarray(bound), max_hops, None if lanes is None else jnp.asarray(lanes.numpy()))
    jst = ttr.walk_state_from_limbs(jax.device_get(js))
    for f in WALK_FIELDS:
        assert torch.equal(getattr(spec, f), getattr(jst, f)), f
        assert torch.equal(getattr(spec, f), getattr(want1, f)), f
    assert int(spec.hops.sum()) > int(st.hops.sum()) and int(again.hops.sum()) > int(spec.hops.sum())
    assert {ttr.ACTIVE, ttr.FULL}.issubset(set(spec.status.tolist()))
    if term:
        assert ttr.TERM in set(spec.status.tolist())


@pytest.mark.parametrize("r", [2, 4])
def test_group_state_equals_jax_shard_for_shard(walk_graphs, r):
    """group_state regroups the 8-way shards r ways as the JAX package's
    does (shard-major ranges joined, then a zeroed trash), every filter,
    shard for shard; the N / r groups on the CPU device share one copy."""
    g = walk_graphs
    tstate = g["mt"].state
    jstate = jsh.ShardedGraphState(*(None if f is None else jnp.asarray(np.stack([t.numpy() for t in f]))
                                     for f in tstate))
    jgroups = jsh.group_state(jsh.make_group_mesh(r, N), jstate, g["cj"])
    states = tsh.group_state(tsh.make_group_mesh(r, _mesh()), tstate, g["ct"])
    assert len(states) == N // r and all(s is states[0] for s in states)
    for name in ("cbf", "rpkbf", "fpkbf"):
        want = np.asarray(getattr(jgroups, name))
        got = np.stack([t.numpy() for t in getattr(states[0], name)])
        assert want.shape == (r, (1 << 18) // r + 1)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert states[0].dbgbf is None and jgroups.dbgbf is None


def test_comm_accounting_of_a_routed_superstep_round_equals_jax():
    """One loop iteration of the routed walk, a speculative round and a
    greedy resolve (lanes ACTIVE and one BRANCH, superstep_hops 2,
    max_supersteps 1), schedules the collectives that the JAX package's
    comm_accounting traces for its walk program: 6 all-to-alls (the
    20-node tree's counts, the candidates' and the lookahead tree's) and 3
    all-reduces (the loop's, the round's and the resolve's decisions),
    with the same bytes a shard (``tests/test_sharded.py``'s case)."""
    kw = dict(k=K, stranded=False, read_pair_distance=20)
    cj = jdbg.GraphConfig(dbgbf=jf.BloomConfig(16, 2), cbf=jf.CountingConfig(16, 2, scratch_log2=20),
                          pkbf=jf.BloomConfig(16, 2), **kw)
    ct = tdbg.GraphConfig(dbgbf=tf.BloomConfig(16, 2), cbf=tf.CountingConfig(16, 2, scratch_log2=20),
                          pkbf=tf.BloomConfig(16, 2), **kw)
    seeds = np.random.default_rng(99).integers(0, 4, size=(16, K), dtype=np.uint8)
    jmesh = jsh.make_mesh(N)
    wj = jtr.WalkConfig(max_len=64, lookahead=3)
    run = jsh.sharded_extend_walks(jmesh, cj, wj, "greedy", True, False)
    with jsh.comm_accounting() as want:
        jax.eval_shape(run, jtr.make_walks(cj, wj, seeds), jsh.make_sharded_graph(cj, jmesh, with_rpkbf=True), 1.0,
                       32)
    wt = ttr.WalkConfig(max_len=64, lookahead=3)
    st = ttr.make_walks(ct, wt, seeds, device="cpu")
    st.status[0] = ttr.BRANCH
    graph = tsh.make_sharded_graph(ct, _mesh(), with_rpkbf=True)
    with tsh.comm_accounting() as got:
        tsh.sharded_extend_walks(_mesh(), ct, wt, "greedy", superstep_hops=2, max_supersteps=1)(st, graph, 1.0, 32)
    assert got == want
    assert got["all_to_all"] == 6 and got["psum"] == 3


def test_unknown_mesh_walk_value_walks_routed(walk_graphs, monkeypatch):
    """Any RNB_MESH_WALK value but replicated and grouped takes the routed
    engine, as in the JAX package; its walks are the single-device walks."""
    g = walk_graphs
    calls = []
    real = tsh.sharded_extend_walks
    monkeypatch.setattr(tsh, "sharded_extend_walks", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    monkeypatch.setenv("RNB_MESH_WALK", "route")
    wt = ttr.WalkConfig(max_len=K + 100)
    rows, lens = _walk_rows(g, "pair")
    got = teng.extend_walks(ttr.make_walks(g["ct"], wt, rows, lens, device="cpu"), g["mt"], g["ct"], wt, 1.0, 50)
    want = ttr.extend_walks(ttr.make_walks(g["ct"], wt, rows, lens, device="cpu"), g["gt"], g["ct"], wt, 1.0, 50)
    assert calls and calls[0] is g["mt"].mesh
    for f in WALK_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_routed_walks_refuse_lanes_that_do_not_split_over_the_shards(walk_graphs, monkeypatch):
    """The JAX routed engine pads nothing: its shard_map raises a ValueError
    where the lanes do not split evenly over the mesh (60 lanes, 8 shards).
    The port raises the same way before any work (ROADMAP §3); the grouped
    engine pads with copies of lane 0 in both packages."""
    g = walk_graphs
    wt = ttr.WalkConfig(max_len=K + 100)
    wj = jtr.WalkConfig(max_len=K + 100)
    rows = g["seeds"][:60]
    st = ttr.take_lanes(ttr.make_walks(g["ct"], wt, rows, device="cpu"), slice(0, 60))
    jst = jax.tree.map(lambda x: x[:60], jtr.make_walks(g["cj"], wj, rows))
    mj = jeng.from_host_state(_jax_graph(g["gt"]), g["cj"], jsh.make_mesh(N))
    monkeypatch.setenv("RNB_MESH_WALK", "routed")
    with pytest.raises(ValueError, match="not evenly divisible"):
        jeng.extend_walks(jst, mj, g["cj"], wj, 1.0, 50)
    with tsh.comm_accounting() as comm, pytest.raises(ValueError, match="not evenly divisible"):
        teng.extend_walks(st, g["mt"], g["ct"], wt, 1.0, 50)
    assert comm["all_to_all"] == 0 and comm["psum"] == 0
    monkeypatch.setenv("RNB_MESH_WALK", "grouped")
    got = teng.extend_walks(st, g["mt"], g["ct"], wt, 1.0, 50)
    want = ttr.extend_walks(st, g["gt"], g["ct"], wt, 1.0, 50)
    for f in WALK_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_group_size_must_divide_the_shards(walk_graphs, monkeypatch):
    """RNB_MESH_GROUP=3 on 8 shards: the JAX package's make_group_mesh
    assertion, in both packages."""
    with pytest.raises(AssertionError, match="group size 3 must divide device count 8"):
        jsh.make_group_mesh(3, N)
    g = walk_graphs
    monkeypatch.setenv("RNB_MESH_WALK", "grouped")
    monkeypatch.setenv("RNB_MESH_GROUP", "3")
    wt = ttr.WalkConfig(max_len=K + 100)
    with pytest.raises(AssertionError, match="group size 3 must divide device count 8"):
        teng.extend_walks(ttr.make_walks(g["ct"], wt, g["seeds"], device="cpu"), g["mt"], g["ct"], wt, 1.0, 50)


@pytest.fixture(scope="module")
def jax_stage2(tmp_path_factory):
    """The JAX package's assemble_pe(sharded="on", stop_stage=2) on its
    8-device mesh on ``tests/test_torch_mesh.py``'s 210 pairs, started once
    a module in a thread (it compiles while the port runs): (pairs, the
    future of its files)."""
    from rnabloom_tpu.assembly import pipeline as jpl

    d = tmp_path_factory.mktemp("jax_stage2")
    left, right = _pairs(str(d))
    kw = dict(total_mem_bytes=1 << 22, batch_size=256, sample_size=100, sharded="on", stop_stage=2)
    pool = ThreadPoolExecutor(1)

    def run():
        jpl.assemble_pe(left, right, str(d / "j"), jpl.PipelineParams(**kw), save_graph=True)
        return _tree(d / "j")

    future = pool.submit(run)
    yield (left, right, kw), future
    pool.shutdown()


@pytest.mark.parametrize("walk_env", ["routed", "grouped"])
def test_assemble_pe_stage2_equals_the_jax_mesh(jax_stage2, tmp_path, monkeypatch, walk_env):
    """The port's assemble_pe(sharded="on") at -stage 2 on 8 CPU shards under
    RNB_MESH_WALK=routed and grouped writes every file of the JAX mesh's
    run (its graph checkpoint, fragment store, readstats and stamps); the
    routed queries and walks route their reads (no replica is made)."""
    (left, right, kw), future = jax_stage2
    mesh = _mesh()
    monkeypatch.setattr(teng, "make_mesh_if_multi", lambda device="cuda", min_devices=2: mesh)
    monkeypatch.setenv("RNB_MESH_WALK", walk_env)
    monkeypatch.delenv("RNB_MESH_GROUP", raising=False)
    monkeypatch.setattr(teng, "_replicated_graph", lambda *a, **k: pytest.fail("a replica of the graph"))
    tsh.reset_routing_counts()
    rep = pipeline.assemble_pe(left, right, str(tmp_path / "t"), pipeline.PipelineParams(**kw), save_graph=True,
                               device="cpu")
    assert tsh.ROUTING["calls"] > 0 and rep.num_fragments > 100
    got, want = _tree(tmp_path / "t"), future.result()
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f
    assert "rnabloom.graph.cbf.npy" in want and any(f.startswith("fragments") for f in want)


@pytest.mark.slow
def test_jax_routed_and_grouped_walks_give_the_golden(walk_graphs, monkeypatch):
    """The JAX package's own routed and grouped (R = 2) walks of the walk
    case on its 8-device mesh, in each mode, have the golden digests."""
    g = walk_graphs
    cj = g["cj"]
    mj = jeng.from_host_state(_jax_graph(g["gt"]), cj, jsh.make_mesh(N))
    for walk_env in ("routed", "grouped"):
        monkeypatch.setenv("RNB_MESH_WALK", walk_env)
        monkeypatch.setenv("RNB_MESH_GROUP", "2")
        for mode, (kw, bound) in WALK_MODES.items():
            rows, lens = _walk_rows(g, mode)
            wj = jtr.WalkConfig(**kw)
            got = jeng.extend_walks(jtr.make_walks(cj, wj, rows, lens), mj, cj, wj, np.float32(1.0), bound, mode=mode)
            got = ttr.walk_state_from_limbs(jax.device_get(got))
            assert _digests(got, _walk_fields(mode)) == g["golden"][mode]["digests"], (walk_env, mode)
