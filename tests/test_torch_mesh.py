"""The port's sharded graph engine (``rnabloom_tpu_torch/parallel/``,
``graph/engine.py``'s mesh branches) against the JAX package's on the
8-device CPU mesh of ``tests/conftest.py``; the port's mesh is 8 shards on
the CPU device.

Filters are compared in every lane outside the trash cells (the JAX
package's sentinel slots write its trash cells, whose values depend on the
bucket capacity; checkpoints and replicas zero them).  The JAX references
are built once a module: JAX compiles one program a shape, so every build
batch has one shape, (4096, 64), whose 40,960 requests a shard and filter
take mean-sized buckets at 8 shards: one round for random reads, two for a
poly-A batch.
"""

import gzip
import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg, engine as jeng, traverse as jtr
from rnabloom_tpu.parallel import sharded as jsh
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg, engine as teng, traverse as ttr
from rnabloom_tpu_torch.ops import cell_insert as ci
from rnabloom_tpu_torch.parallel import sharded as tsh
from stage3_common import naive_walk_rows, pair_walk_rows, sim_walk_data
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

K = 25
N = 8
CONFIGS = ("exact", "cm", "cm_blocked", "cm_mf8")
SHAPE = (4096, 64)
WALK_FIELDS = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")


def _cfgs(name):
    """(JAX config, port config): ``tests/test_sharded.py``'s, with a
    fragment-pair distance for the rebuild step."""
    cbf = dict(size_log2=16, num_hash=2, scratch_log2=20, blocked=name == "cm_blocked",
               dtype="mf8" if name == "cm_mf8" else "int32")
    kw = dict(k=K, stranded=False, read_pair_distance=20, fragment_pair_distance=30, exact_counts=name == "exact")
    return (jdbg.GraphConfig(dbgbf=jf.BloomConfig(16, 2), cbf=jf.CountingConfig(**cbf), pkbf=jf.BloomConfig(16, 2),
                             **kw),
            tdbg.GraphConfig(dbgbf=tf.BloomConfig(16, 2), cbf=tf.CountingConfig(**cbf), pkbf=tf.BloomConfig(16, 2),
                             **kw))


def _batches():
    """Random reads, a poly-A batch (3/4 of its rows poly-A: its buckets
    overflow into a second round), and random fragments for the rebuild."""
    rng = np.random.default_rng(16)
    rand = rng.integers(0, 4, size=SHAPE, dtype=np.uint8)
    rand[::97, 40:] = 4  # short rows and invalid k-mers
    polya = rng.integers(0, 4, size=SHAPE, dtype=np.uint8)
    polya[: 3 * SHAPE[0] // 4] = 0
    frags = rng.integers(0, 4, size=SHAPE, dtype=np.uint8)
    frags[5, 30] = 4
    return {"random": rand, "polya": polya, "rebuild": frags}


def _mesh():
    return tsh.make_mesh(["cpu"] * N)


def _trash(cfg, name):
    return 128 if name == "cbf" and cfg.cbf.blocked else 1


def _assert_same_filters(jstate, tstate, cfg, what):
    """Every shard's lanes outside its trash equal the JAX mesh's (u16
    cells compared as bit patterns)."""
    for name in ("dbgbf", "cbf", "rpkbf", "fpkbf"):
        j, t = getattr(jstate, name), getattr(tstate, name)
        assert (j is None) == (t is None), (what, name)
        if j is None:
            continue
        trash = _trash(cfg, name)
        want = np.asarray(j)[:, :-trash]
        got = np.stack([s.numpy() for s in t])[:, :-trash].view(want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {name}")


def _build_config(name, batches):
    """The JAX and port mesh states after each step of ``built``."""
    jmesh, tmesh = jsh.make_mesh(N), _mesh()
    cj, ct = _cfgs(name)
    jbuild = jsh.sharded_build_step(jmesh, cj, add_read_pairs=True)
    jrebuild = jsh.sharded_rebuild_step(jmesh, cj)
    tbuild = tsh.sharded_build_step(tmesh, ct, add_read_pairs=True)
    trebuild = tsh.sharded_rebuild_step(tmesh, ct)
    js = jsh.make_sharded_graph(cj, jmesh, with_rpkbf=True)
    ts = tsh.make_sharded_graph(ct, tmesh, with_rpkbf=True)
    single = tdbg.make_graph(ct, with_rpkbf=True, device="cpu")
    steps = {}
    for salt, kind in enumerate(("random", "polya", "rebuild")):
        codes = batches[kind]
        if kind == "rebuild":
            js = js._replace(fpkbf=jsh.make_sharded_graph(cj, jmesh, with_fpkbf=True).fpkbf)
            ts = ts._replace(fpkbf=tsh.make_sharded_graph(ct, tmesh, with_fpkbf=True).fpkbf)
            single = single._replace(fpkbf=tf.make_bloom(ct.pkbf, device="cpu"))
            js = jrebuild(js, jnp.asarray(codes), salt)
            with tsh.comm_accounting() as comm:
                ts = trebuild(ts, codes, salt)
            single = tdbg.rebuild_step(single, ct, torch.from_numpy(codes), salt=salt)
        else:
            js = jbuild(js, jnp.asarray(codes), salt)
            with tsh.comm_accounting() as comm:
                ts = tbuild(ts, codes, salt)
            single = tdbg.build_step(single, ct, torch.from_numpy(codes), add_read_pairs=True, salt=salt)
        steps[kind] = (jax.device_get(js), tsh.ShardedGraphState(*(
            None if x is None else tuple(s.clone() for s in x) for x in ts)),
            tdbg.GraphState(*(None if x is None else x.clone() for x in single)), dict(comm))
    return cj, ct, steps, ts, single


@pytest.fixture(scope="module")
def built():
    """name -> the JAX and port mesh states after each step, the port's
    single-device build of the same batches, and the collectives of each
    port step: build(random, salt 0), build(polya, salt 1), then the
    rebuild of the random fragments (salt 2) on the counters and a fresh
    fpkbf.  The configurations run in threads, so that JAX compiles their
    programs at once."""
    batches = _batches()
    with ThreadPoolExecutor(len(CONFIGS)) as pool:
        runs = {name: pool.submit(_build_config, name, batches) for name in CONFIGS}
        return {name: run.result() for name, run in runs.items()}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kind", ["random", "polya", "rebuild"])
def test_sharded_steps_equal_jax_and_single_device(built, name, kind):
    """Every lane outside the trash equals the JAX mesh's after the same
    step, and the port's single-device build of the same batches."""
    cj, ct, steps, _, _ = built[name]
    jstate, tstate, single, comm = steps[kind]
    _assert_same_filters(jstate, tstate, ct, f"{name} after {kind}")
    host = teng.to_host_state(teng.MeshGraph(mesh=_mesh(), state=tstate), ct)
    for field in ("dbgbf", "cbf", "rpkbf", "fpkbf"):
        a, b = getattr(single, field), getattr(host, field)
        assert (a is None) == (b is None), field
        if a is not None:
            tr = _trash(ct, field)
            assert torch.equal(a[:-tr], b[:-tr]), f"{name} after {kind}: {field} differs from the single-device build"
    # a poly-A batch overflows the cbf's mean-sized buckets into a second
    # round, random reads do not; the blocked cbf routes one packed word a
    # k-mer (20,480 a shard: one round of capacity m, no decision to sum)
    rounds = 2 if kind == "polya" else 1
    if ct.exact_counts:  # dbgbf lookup 2 and insert 1, cbf gather 2 and max 2 a round; pair keys 1
        assert (comm["all_to_all"], comm["psum"]) == (7 * rounds + 1, 5), comm
    elif ct.cbf.blocked:
        assert (comm["all_to_all"], comm["psum"]) == (2, 0), comm
    else:
        assert (comm["all_to_all"], comm["psum"]) == (rounds + 1, 1), comm


def test_routed_rounds_all_requests_to_one_shard():
    """Every request of every shard targets shard 3: a mean-sized bucket
    takes 5,888 of a shard's 40,960, the second round the rest; every
    request is delivered once, as the JAX package's router delivers them."""
    mesh, m, cells = _mesh(), 40960, 16
    lidx = [torch.arange(m, dtype=torch.int64) % cells for _ in range(N)]
    target = [torch.full((m,), 3, dtype=torch.int64) for _ in range(N)]
    with tsh.comm_accounting() as comm:
        routed = tsh._routed_rounds(mesh, lidx, target, cells)
    assert tsh._bucket_capacity(m, N) == 5888
    assert comm == {"all_to_all": 2, "psum": 1, "a2a_bytes_per_shard": N * (5888 + m) * 4,
                    "psum_bytes_per_shard": 4}
    tables = [torch.zeros(cells + 1, dtype=torch.int32) for _ in range(N)]
    for t, r in zip(tables, routed.received):
        ci.cell_insert(t, r, "add")
    got = torch.stack(tables)[:, :cells].numpy()

    # the JAX router on the same requests
    from jax.sharding import PartitionSpec as P

    def local(flat, li, t):
        def add_fn(fl, req, _):
            return fl.at[req.reshape(-1)].add(np.int32(1), mode="drop"), ()

        flat, _ = jsh._routed_rounds(flat[0], li, t, (), N, "d", cells, add_fn)
        return flat[None]

    prog = jsh.shard_map(local, mesh=jsh.make_mesh(N), in_specs=(P("d", None), P("d"), P("d")),
                         out_specs=P("d", None), check_vma=False)
    want = np.asarray(jax.jit(prog)(jnp.zeros((N, cells + 1), jnp.int32),
                                    jnp.asarray(np.arange(N * m, dtype=np.uint32) % cells),
                                    jnp.full((N * m,), 3, jnp.int32)))[:, :cells]
    np.testing.assert_array_equal(got, want)
    assert got[3].sum() == N * m and (np.delete(got, 3, axis=0) == 0).all()


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("walk_env", ["replicated", "routed"])
def test_mesh_queries_equal_single_device(built, monkeypatch, name, walk_env):
    """count_step, pair_support_both, counts_and_read_support and
    variant_exists on the mesh, replicated and routed, equal the
    single-device engine's on the same filters; the routed count equals
    the JAX package's routed count query."""
    monkeypatch.setenv("RNB_MESH_WALK", walk_env)
    cj, ct, steps, tstate, single = built[name]
    jstate = steps["rebuild"][0]
    mg = teng.MeshGraph(mesh=_mesh(), state=tstate)
    rng = np.random.default_rng(3)
    batches = _batches()
    probes = np.concatenate([batches["random"][:40], batches["polya"][-10:], batches["polya"][:6],
                             rng.integers(0, 4, size=(9, 64), dtype=np.uint8)])  # 65 rows: padded to 72
    c1, v1 = teng.count_step(single, ct, probes)
    c8, v8 = teng.count_step(mg, ct, probes)
    assert torch.equal(v1, v8) and torch.equal(c1, c8)
    assert int((c1 > 0).sum()) > 1000
    for d_frag, d_read in ((30, 20), (0, 20), (30, 0)):
        np.testing.assert_array_equal(teng.pair_support_both(mg, ct, probes, d_frag, d_read),
                                      teng.pair_support_both(single, ct, probes, d_frag, d_read))
    for a, b in zip(teng.counts_and_read_support(mg, ct, probes), teng.counts_and_read_support(single, ct, probes)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(teng.variant_exists(mg, ct, probes), teng.variant_exists(single, ct, probes)):
        np.testing.assert_array_equal(a, b)
    if walk_env == "routed":
        jc, jv = jsh.sharded_count_query(jsh.make_mesh(N), cj)(jstate, jnp.asarray(teng._pad_rows(probes, N)))
        np.testing.assert_array_equal(c8.numpy(), np.asarray(jc)[: len(probes)])
        np.testing.assert_array_equal(v8.numpy(), np.asarray(jv)[: len(probes)])


def test_comm_accounting_one_round_build_step_equals_jax():
    """A one-round build step (32 reads) on the exact path schedules the
    JAX package's collectives: 8 all-to-alls (dbgbf lookup 2 and insert 1,
    cbf gather 2 and max 2, rpkbf insert 1) and the scratch sketch's sum,
    with the same bytes a shard."""
    cj, ct = _cfgs("exact")
    codes = np.random.default_rng(5).integers(0, 4, size=(32, 64), dtype=np.uint8)
    jmesh = jsh.make_mesh(N)
    with jsh.comm_accounting() as want:
        jax.eval_shape(jsh.sharded_build_step(jmesh, cj, add_read_pairs=True),
                       jsh.make_sharded_graph(cj, jmesh, with_rpkbf=True), jnp.asarray(codes))
    step = tsh.sharded_build_step(_mesh(), ct, add_read_pairs=True)
    state = tsh.make_sharded_graph(ct, _mesh(), with_rpkbf=True)
    with tsh.comm_accounting() as got:
        step(state, codes)
    assert got == want
    assert got["all_to_all"] == 8 and got["psum"] == 1


@pytest.mark.parametrize("name", CONFIGS)
def test_host_state_round_trip_equals_jax(built, name):
    """to_host_state merges the shards into the single-device layout with
    zeroed trash, as the JAX package's does; from_host_state splits it
    back, each shard's trash zeroed."""
    cj, ct, steps, _, _ = built[name]
    jstate, tstate, _, _ = steps["rebuild"]
    jmesh = jsh.make_mesh(N)
    jhost = jeng.to_host_state(jeng.MeshGraph(mesh=jmesh, state=jstate), cj)
    thost = teng.to_host_state(teng.MeshGraph(mesh=_mesh(), state=tstate), ct)
    for field in ("dbgbf", "cbf", "rpkbf", "fpkbf"):
        j, t = getattr(jhost, field), getattr(thost, field)
        assert (j is None) == (t is None)
        if j is not None:
            want = np.asarray(j)
            np.testing.assert_array_equal(t.numpy().view(want.dtype), want, err_msg=field)
    back = teng.from_host_state(thost, ct, _mesh())
    jback = jeng.from_host_state(jhost, cj, jmesh)
    for field in ("dbgbf", "cbf", "rpkbf", "fpkbf"):
        j, t = getattr(jback.state, field), getattr(back.state, field)
        if j is not None:
            want = np.asarray(j)
            np.testing.assert_array_equal(np.stack([s.numpy() for s in t]).view(want.dtype), want, err_msg=field)
    assert all(s.storage_offset() == 0 for s in back.state.cbf)
    assert teng.fprs(back, ct) == jsh.sharded_fprs(jback.state, cj)


def test_mf8_plain_insert_with_base_equals_jax():
    """add_mf8 with a base keys each cell's rounding by base + index, as
    ``apply_cell_increments(base_index=)`` does; base 0 is the whole-table
    insert."""
    rng = np.random.default_rng(8)
    cells0 = rng.integers(0, 120, size=1025, dtype=np.uint8)
    idx = rng.integers(0, 1025, size=5000).astype(np.int64)
    idx[:300] = 7  # a heavy cell
    hist = jnp.asarray(np.bincount(idx, minlength=1025).astype(np.int32))
    apply = jax.jit(jf.apply_cell_increments, static_argnames=("dtype",))
    for salt in (0, 5):
        for base in (0, 3 << 20, (1 << 31) + 5, (1 << 32) - 100):
            got = torch.from_numpy(cells0.copy())
            ci.cell_insert(got, torch.from_numpy(idx), "add_mf8", salt, base=base)
            want = np.asarray(apply(jnp.asarray(cells0), hist, "mf8", salt=np.uint32(salt), base_index=np.uint32(base)))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"salt {salt} base {base}")
    plain = torch.from_numpy(cells0.copy())
    ci.cell_insert(plain, torch.from_numpy(idx), "add_mf8", 5)
    based = torch.from_numpy(cells0.copy())
    ci.cell_insert(based, torch.from_numpy(idx), "add_mf8", 5, base=0)
    assert torch.equal(plain, based)
    with pytest.raises(ValueError, match="uint32"):
        ci.cell_insert(based, torch.from_numpy(idx), "add_mf8", 5, base=1 << 32)


# ---------------------------------------------------------------------------
# walks on a mesh
# ---------------------------------------------------------------------------


def _walk_case():
    """Reads of tests/stage3_common.sim_walk_data plus a 4,600-base
    transcript twice over, and the greedy seeds: the sim seeds, k-mers of
    the long transcript (their lanes reach the superstep cap, 64
    supersteps, at about 1,100 hops: false-positive branches end many
    supersteps early) and 4,250-base prefixes of it (their lanes fill the
    buffer, max_len 4,400 + k)."""
    reads, seeds = sim_walk_data()
    rng = np.random.default_rng(3)
    long_tx = rng.integers(0, 4, size=4600, dtype=np.uint8)
    lreads = np.stack([long_tx[s : s + 100] for s in range(0, 4500, 20)])
    width = 4250
    greedy = np.full((len(seeds) + 4, width), 4, np.uint8)
    greedy[: len(seeds), :K] = seeds
    greedy[len(seeds), :K] = long_tx[:K]
    greedy[len(seeds) + 1, :K] = long_tx[100 : 100 + K]
    greedy[len(seeds) + 2 :] = long_tx[:width]
    lens = np.array([K] * (len(seeds) + 2) + [width, width - 37])
    return np.concatenate([reads, lreads, lreads]), reads, seeds, greedy, lens


def _walk_configs():
    kw = dict(k=K, stranded=False, read_pair_distance=40, fragment_pair_distance=60)
    return (jdbg.GraphConfig(dbgbf=jf.BloomConfig(18, 2), cbf=jf.CountingConfig(18, 2, dtype="mf8"),
                             pkbf=jf.BloomConfig(18, 2), **kw),
            tdbg.GraphConfig(dbgbf=tf.BloomConfig(18, 2), cbf=tf.CountingConfig(18, 2, dtype="mf8"),
                             pkbf=tf.BloomConfig(18, 2), **kw))


def _sha1(t: torch.Tensor) -> str:
    return hashlib.sha1(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()


def _digests(state, fields) -> dict:
    return {f: _sha1(getattr(state, f)) for f in fields}


@pytest.fixture(scope="module")
def walk_graphs():
    """The walk case's graph (mf8, 2^18 cells, read and fragment pair keys)
    built by the port on one device, and the same filters on the port's
    mesh."""
    allreads, reads, seeds, greedy, lens = _walk_case()
    _, ct = _walk_configs()
    gt = tdbg.make_graph(ct, with_rpkbf=True, with_fpkbf=True, device="cpu")
    gt = tdbg.rebuild_step(tdbg.build_step(gt, ct, torch.from_numpy(allreads), add_read_pairs=True), ct,
                           torch.from_numpy(allreads))
    return dict(ct=ct, gt=gt, mt=teng.from_host_state(gt, ct, _mesh()), reads=reads, seeds=seeds, greedy=greedy,
                lens=lens)


# mode -> (walk config kwargs, bound)
WALK_MODES = {
    "greedy": (dict(max_len=K + 4400), np.int32(4500)),
    "pair": (dict(max_len=K + 400, pair_ring=64), np.int32(300)),
    "naive": (dict(max_len=K + 700, check_back_branches=True), np.int32(500)),
}
WALKS_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mesh_walks.json")


def _walk_rows(g, mode):
    if mode == "greedy":
        return g["greedy"], g["lens"]
    if mode == "pair":
        return pair_walk_rows("sim", g["reads"], g["seeds"])
    return naive_walk_rows("sim", g["reads"], g["seeds"]), None


def _walk_fields(mode):
    return WALK_FIELDS + (("ring_fh", "ring_rh") if mode == "pair" else ())


@pytest.mark.parametrize("mode", list(WALK_MODES))
def test_mesh_walks_equal_the_jax_walks(walk_graphs, mode):
    """The port's mesh walk (the replica on the mesh's device) equals, in
    every field, the JAX package's walks of the same seeds on the same
    graph, on one device and on its 8-device mesh: both have the digests
    of ``tests/golden/mesh_walks.json``, which
    ``test_jax_mesh_walks_equal_its_single_device_walks`` re-derives
    (slow: JAX compiles six walk programs).  Greedy lanes fill their
    buffers and stay ACTIVE at the superstep cap."""
    g = walk_graphs
    with open(WALKS_GOLDEN) as f:
        golden = json.load(f)
    assert {name: _sha1(getattr(g["gt"], name)) for name in ("cbf", "rpkbf", "fpkbf")} == golden["graph"]
    rep = teng._replicated_graph(g["mt"], g["ct"])
    assert all(torch.equal(getattr(rep, f), getattr(g["gt"], f)) for f in ("cbf", "rpkbf", "fpkbf"))
    kw, bound = WALK_MODES[mode]
    rows, lens = _walk_rows(g, mode)
    wt = ttr.WalkConfig(**kw)
    got = teng.extend_walks(ttr.make_walks(g["ct"], wt, rows, lens, device="cpu"), g["mt"], g["ct"], wt,
                            np.float32(1.0), bound, mode=mode)
    assert _digests(got, _walk_fields(mode)) == golden[mode]["digests"]
    status = set(got.status.tolist())
    assert ttr.DEAD in status and int(got.hops.sum()) > 0
    if mode == "greedy":
        assert ttr.FULL in status and ttr.ACTIVE in status
        assert int(got.pos.max()) == wt.max_len - 1
    else:
        assert ttr.STOPPED_BRANCH in status


def test_mesh_walks_split_lanes_over_devices(walk_graphs):
    """With several devices, each walks a contiguous run of the lanes on
    its own replica; the runs join into the one-device walk (two runs on
    the CPU device here)."""

    class TwoDevices(type(_mesh())):
        @property
        def distinct(self):
            return (torch.device("cpu"),) * 2

    g = walk_graphs
    mg = teng.MeshGraph(mesh=TwoDevices(_mesh().devices), state=g["mt"].state)
    kw, bound = WALK_MODES["naive"]
    rows, _ = _walk_rows(g, "naive")
    wt = ttr.WalkConfig(**kw)
    rng = np.random.default_rng(9)
    W = ttr.make_walks(g["ct"], wt, rows, device="cpu").pos.shape[0]
    min_cov = rng.choice([1.0, 2.0, 0.5], size=W).astype(np.float32)
    bounds = rng.integers(50, 500, size=W).astype(np.int32)
    got = teng.extend_walks(ttr.make_walks(g["ct"], wt, rows, device="cpu"), mg, g["ct"], wt, min_cov, bounds,
                            mode="naive")
    want = ttr.extend_walks(ttr.make_walks(g["ct"], wt, rows, device="cpu"), g["gt"], g["ct"], wt, min_cov, bounds,
                            mode="naive")
    for f in WALK_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.slow
def test_jax_mesh_walks_equal_its_single_device_walks():
    """The JAX package's mesh walk (its default replicated engine: the
    grouped engine at R = 1, speculative depth-2 supersteps) equals its
    single-device walk in every field, in each mode, on the walk case;
    their digests are the golden's (``MESH_WALKS_GOLDEN_WRITE=1`` writes
    it).  About 45 s: JAX compiles six walk programs."""
    allreads, reads, seeds, greedy, lens = _walk_case()
    cj, _ = _walk_configs()
    gj = jdbg.make_graph(cj, with_rpkbf=True, with_fpkbf=True)
    gj = jdbg.rebuild_step(jdbg.build_step(gj, cj, jnp.asarray(allreads), add_read_pairs=True), cj,
                           jnp.asarray(allreads))
    mj = jeng.from_host_state(gj, cj, jsh.make_mesh(N))
    g = dict(reads=reads, seeds=seeds, greedy=greedy, lens=lens)
    golden = {"graph": {name: _sha1(torch.from_numpy(np.asarray(getattr(gj, name))))
                        for name in ("cbf", "rpkbf", "fpkbf")}}
    for mode, (kw, bound) in WALK_MODES.items():
        rows, lens_ = _walk_rows(g, mode)
        wj = jtr.WalkConfig(**kw)
        single = jtr.extend_walks(jtr.make_walks(cj, wj, rows, lens_), gj, cj, wj, np.float32(1.0), bound, mode=mode)
        mesh = jeng.extend_walks(jtr.make_walks(cj, wj, rows, lens_), mj, cj, wj, np.float32(1.0), bound, mode=mode)
        single = ttr.walk_state_from_limbs(jax.device_get(single))
        mesh = ttr.walk_state_from_limbs(jax.device_get(mesh))
        for f in _walk_fields(mode):
            assert torch.equal(getattr(mesh, f), getattr(single, f)), (mode, f)
        golden[mode] = {"digests": _digests(single, _walk_fields(mode)),
                        "statuses": np.bincount(single.status.numpy(), minlength=7).tolist(),
                        "max_hops": int(single.hops.max())}
    if os.environ.get("MESH_WALKS_GOLDEN_WRITE") == "1":
        with open(WALKS_GOLDEN, "w") as f:
            json.dump(golden, f, indent=1, sort_keys=True)
            f.write("\n")
    with open(WALKS_GOLDEN) as f:
        assert json.load(f) == golden


# ---------------------------------------------------------------------------
# the CLI and the pipeline on a mesh
# ---------------------------------------------------------------------------


def test_cpu_and_single_card_make_no_mesh():
    assert teng.make_mesh_if_multi("cpu") is None
    with pytest.raises(ValueError, match="power-of-two"):
        tsh.make_mesh(["cpu"] * 3)
    with pytest.raises(RuntimeError, match="requires >1 CUDA device"):
        pipeline._mesh_for(pipeline.PipelineParams(sharded="on"), torch.device("cpu"))
    assert pipeline._mesh_for(pipeline.PipelineParams(sharded="auto"), torch.device("cpu")) is None


@pytest.mark.parametrize("argv,error,match", [
    # the sharded multi-host layout is refused before the group would start
    (["-coordinator", "127.0.0.1:9", "-nprocs", "2", "-mhlayout", "sharded"], NotImplementedError,
     "-mhlayout is not ported yet: ROADMAP queue-1 item 14c$"),
    (["-nprocs", "2", "-mhlayout", "sharded"], NotImplementedError,
     "-mhlayout is not ported yet: ROADMAP queue-1 item 14c$"),
    (["-sharded", "on"], RuntimeError, "-sharded on requires >1 CUDA device"),
    (["-sharded", "on", "-k", "25,27"], RuntimeError, "-sharded on requires >1 CUDA device"),
], ids=["coordinator", "nprocs", "sharded_on_one_device", "sharded_on_before_k_selection"])
def test_cli_refusals_before_any_work(tmp_path, argv, error, match):
    out = tmp_path / "asm"
    with pytest.raises(error, match=match):
        cli.run(["-left", str(tmp_path / "missing_1.fq"), "-right", str(tmp_path / "missing_2.fq"), "-o", str(out),
                 "--device", "cpu"] + argv)
    assert not out.exists()


def _pairs(d):
    """``tests/test_sharded.py``'s 210 pairs: 3 transcripts of 450 bases,
    100-base mates of 250-base fragments, the right mate reverse
    complemented."""
    from rnabloom_tpu_torch.utils import seq as sequtils

    rng = np.random.default_rng(4242)

    def rseq(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    transcripts = [rseq(450) for _ in range(3)]
    left, right = os.path.join(d, "m_1.fq.gz"), os.path.join(d, "m_2.fq.gz")
    q = "I" * 100
    with gzip.open(left, "wt") as fl, gzip.open(right, "wt") as fr:
        rid = 0
        for t in transcripts:
            for _ in range(70):
                s = rng.integers(0, len(t) - 250 + 1)
                frag = t[s : s + 250]
                fl.write(f"@r{rid}/1\n{frag[:100]}\n+\n{q}\n")
                fr.write(f"@r{rid}/2\n{sequtils.revcomp(frag[-100:])}\n+\n{q}\n")
                rid += 1
    return left, right


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


def _assemble_both(tmp_path, monkeypatch, stage):
    """The port's assemble_pe(sharded="on") on 8 CPU shards and the JAX
    package's on its 8 virtual devices, on the 210 pairs: every output
    file equal (report.json but elapsed_s)."""
    from rnabloom_tpu.assembly import pipeline as jpl

    left, right = _pairs(str(tmp_path))
    mesh = _mesh()
    monkeypatch.setattr(teng, "make_mesh_if_multi", lambda device="cuda", min_devices=2: mesh)
    kw = dict(total_mem_bytes=1 << 22, batch_size=256, sample_size=100, sharded="on", stop_stage=stage)
    meshes = []
    real_build = tsh.sharded_build_step
    monkeypatch.setattr(tsh, "sharded_build_step", lambda m, *a, **k: meshes.append(m) or real_build(m, *a, **k))
    with ThreadPoolExecutor(2) as pool:  # JAX compiles while the port runs
        jrun = pool.submit(jpl.assemble_pe, left, right, str(tmp_path / "j"), jpl.PipelineParams(**kw),
                           save_graph=True)
        trep = pipeline.assemble_pe(left, right, str(tmp_path / "t"), pipeline.PipelineParams(**kw),
                                    save_graph=True, device="cpu")
        jrep = jrun.result()
    assert meshes and all(m is mesh for m in meshes)  # stage 1 ran on the mesh
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(got) == sorted(want)
    if stage >= 3:
        a, b = json.loads(got.pop("rnabloom.report.json")), json.loads(want.pop("rnabloom.report.json"))
        assert a.pop("elapsed_s") >= 0 and b.pop("elapsed_s") >= 0
        assert a == b
    for f in want:
        assert got[f] == want[f], f
    assert trep.num_fragments == jrep.num_fragments > 100
    return trep, want


def test_assemble_pe_mesh_stage2_equals_jax_mesh(tmp_path, monkeypatch):
    _, want = _assemble_both(tmp_path, monkeypatch, 2)
    assert "rnabloom.graph.cbf.npy" in want and any(f.startswith("fragments") for f in want)


@pytest.mark.slow
def test_assemble_pe_mesh_stage3_equals_jax_mesh(tmp_path, monkeypatch):
    trep, want = _assemble_both(tmp_path, monkeypatch, 3)
    assert trep.num_transcripts > 0 and want["rnabloom.transcripts.fa"]


@pytest.mark.slow
def test_exact_mf8_mesh_sketch_wraps_as_the_jax_mesh_does():
    """The JAX package's sharded conservative update keeps its scratch
    multiplicity sketch in the cells' dtype (uint8 for mf8), which wraps
    past 255 occurrences in a batch where its single-device int32 sketch
    does not; the port's mesh follows the JAX mesh (ROADMAP §3)."""
    cj, ct = _cfgs("exact")
    cbf = dict(size_log2=16, num_hash=2, scratch_log2=20, dtype="mf8")
    cj = cj.__class__(**{**cj.__dict__, "cbf": jf.CountingConfig(**cbf)})
    ct = ct.__class__(**{**ct.__dict__, "cbf": tf.CountingConfig(**cbf)})
    codes = np.random.default_rng(21).integers(0, 4, size=(64, 64), dtype=np.uint8)
    codes[:40] = 0  # one k-mer 1,600 times: its multiplicity wraps to 64 in a uint8 sketch
    jmesh = jsh.make_mesh(N)
    js = jsh.sharded_build_step(jmesh, cj)(jsh.make_sharded_graph(cj, jmesh), jnp.asarray(codes))
    ts = tsh.sharded_build_step(_mesh(), ct)(tsh.make_sharded_graph(ct, _mesh()), codes)
    _assert_same_filters(jax.device_get(js), ts, ct, "exact mf8")
    single = tdbg.build_step(tdbg.make_graph(ct, device="cpu"), ct, torch.from_numpy(codes))
    host = teng.to_host_state(teng.MeshGraph(mesh=_mesh(), state=ts), ct)
    assert not torch.equal(host.cbf[:-1], single.cbf[:-1])
