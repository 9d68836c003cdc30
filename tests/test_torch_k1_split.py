"""K1's row split (``kernels/seg_agg.py``, ``csrc/seg_agg.cu``) on the CPU.

The kernel's 32 fold units share a block's work -- its rows to store and
its slots to fold -- and a row of more than ``split_threshold(emax)``
slots is cut at each unit start inside it, its chunks folded side by side
and their sums added in chunk order; a shorter row is one in-order fold.
The rule is a pure function of the shapes (``split_threshold``,
``max_chunks``, ``fold_smem_bytes``) and of the row lengths
(``unit_starts``, ``chunk_plan``), which these tests hold: every valid
slot in exactly one chunk, rows of at most T slots whole, chunks no longer
than a unit's share, the threshold a function of ``emax`` alone, the
chunk sums inside shared memory at the port's layouts, and every forward
row of the paper's graphs unsplit.

A hub-row graph -- one source feeding 3,000 destinations, so its
transposed layout (K1's backward) holds a row the kernel splits -- goes
through K1's autograd Function on the CPU (the cuda tier's path with its
device check lifted, the kernel's plain version inside) against
``jax.grad`` of the reference's ``aggregate``, in the f32 band
(``tests/tolerance.py``).  ``tests/test_torch_cuda.py`` holds the kernel
itself against the plain version on a card over rows of T, T + 1, T k,
T k + 1, 7,000 and 50,000 slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.core.phases import aggregate as jaggregate
from repro.graph.structure import graph_from_coo as jgraph_from_coo
from repro_torch.config import GRAPHS
from repro_torch.core import dataflow
from repro_torch.core.phases import aggregate
from repro_torch.graph.structure import graph_from_coo
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1

torch.set_num_threads(2)

#: the layouts' emax on the port's paths: Reddit's forward aggregation
#: layout (1821 x 6664 at tile 128, as phase 3 of chip_smoke.py prints
#: it), a smaller forward block, phase 11's transposed block 0 (1145 x
#: 7120), and a block of 2^20 slots
EMAX = (1760, 6664, 7120, 2 ** 20)
#: the hub-row graph: vertices, the hub's destinations, other edges
HUB_V, HUB_FANOUT, HUB_OTHER = 4000, 3000, 2000
TILE = 32


@pytest.mark.parametrize("emax", [8, 300, *EMAX, 16384, 16392, 65536])
def test_split_threshold_is_a_function_of_emax(emax):
    """T is at least MIN_SPLIT and emax / SPLIT_WAYS, set by emax alone:
    any rows in a block of emax slots meet the same T, and no block can
    hold more chunks than ``max_chunks``, even rows of T + 1 slots each
    with every unit start inside one."""
    t = k1.split_threshold(emax)
    assert t >= k1.MIN_SPLIT and t * k1.SPLIT_WAYS >= emax
    assert k1.max_chunks(emax) < k1.SPLIT_WAYS + k1.FOLD_UNITS
    rows = [t + 1] * (emax // (t + 1))
    if rows:
        items = k1.chunk_plan(rows, emax)
        assert sum(o >= 0 for *_, o in items) <= k1.max_chunks(emax)


def _lengths(kind: str, emax: int, rng) -> list:
    """Row lengths of one block of ``emax`` slots."""
    t = k1.split_threshold(emax)
    if kind == "edges":          # T, T + 1, T k, T k + 1
        rows = [t, t + 1, 3 * t, 3 * t + 1, 0, 1]
    elif kind == "hub":          # a sampled hub among short rows
        rows = [5, 0, 7000, 3, 40] + [0, 1, 0] * 20
    elif kind == "long":
        rows = [50000, 2, 0]
    else:                        # random, some rows far past T
        rows = list(rng.integers(0, 3 * t, size=20))
    rows = [int(n) for n in rows]
    assert sum(rows) <= emax
    return rows


@pytest.mark.parametrize("kind,emax", [
    ("edges", 7120), ("edges", 65536), ("hub", 7120), ("hub", 65536),
    ("long", 65536), ("random", 65536), ("random", 2 ** 20)])
def test_chunk_plan_covers_every_slot_once(kind, emax):
    """Items in slot order cover the valid slots exactly once; a row of at
    most T slots is one item (stored, ordinal -1); a longer row is cut at
    exactly the unit starts strictly inside its slots, its chunks' ordinals
    running on from the block's earlier split rows, under ``max_chunks``,
    and no chunk longer than a unit's share of the block's work."""
    rows = _lengths(kind, emax, np.random.default_rng(emax))
    t = k1.split_threshold(emax)
    starts = k1.unit_starts(rows)
    share = (sum(rows) + len(rows)) // k1.FOLD_UNITS + 1
    items = k1.chunk_plan(rows, emax)
    slot, ordinal = 0, 0
    for row, n in enumerate(rows):
        mine = [it for it in items if it[0] == row]
        assert mine[0][1] == slot and mine[-1][2] == slot + n
        assert all(a[2] == b[1] for a, b in zip(mine, mine[1:]))
        if n <= t:
            assert mine == [(row, slot, slot + n, -1)]
        else:
            cuts = [a for _, a, _, _ in mine[1:]]
            assert cuts == [p - row - 1 for p in starts
                            if slot < p - row - 1 < slot + n]
            assert all(0 < e - s <= share for _, s, e, _ in mine)
            assert [o for *_, o in mine] == list(range(ordinal,
                                                       ordinal + len(mine)))
            ordinal += len(mine)
        slot += n
    assert [it[1] for it in items] == sorted(it[1] for it in items)
    assert ordinal <= k1.max_chunks(emax)
    if kind == "hub":    # the hub is spread over the units
        assert sum(1 for it in items if it[0] == 2) >= 7000 // share
    with pytest.raises(ValueError):
        k1.chunk_plan(rows + [emax], emax)


def test_unit_starts_share_rows_and_slots():
    """Unit k starts at position k W / 32 of W = slots + rows: a block of
    empty rows spreads them over the units, four each; a block of one row
    of 3,200 slots cuts it 31 times."""
    assert k1.unit_starts([0] * 128) == [4 * k for k in range(1, 32)]
    items = k1.chunk_plan([3200], 3200)
    assert len(items) == 32 and all(o == i for i, (*_, o) in
                                    enumerate(items))
    assert max(e - s for _, s, e, _ in items) <= 3201 // 32 + 1


@pytest.mark.parametrize("f,elt,want", [
    (128, 4, 32), (41, 4, 8), (602, 4, 16), (128, 2, 64), (7, 4, 7),
    (1, 4, 1)])
def test_backward_slices_take_one_load_a_lane(f, elt, want):
    """K1's backward walks x in slices of one load a lane a slot: 32
    columns at F = 128 (16-byte loads), 8 at F = 41, 64 for bf16 at 128,
    never wider than F or ``MAX_SLICE``."""
    w = k1.backward_slice_cols(f, elt, 16)
    assert w == want
    assert k1.launch_params(f, w, elt, 16)[1] == 1
    assert 0 < w <= min(f, k1.MAX_SLICE)


@pytest.mark.parametrize("emax", EMAX)
@pytest.mark.parametrize("tile_m", [128, 256])
def test_chunk_sums_fit_shared_memory(emax, tile_m):
    """The fold CTA's shared memory (chunk table and chunk sums at the
    widest slice) at the port's layouts: inside what a CTA takes without
    opting in, and so inside the card's limit."""
    smem = k1.fold_smem_bytes(tile_m, emax, k1.MAX_SLICE)
    assert smem == 4 * (2 * (tile_m + 1)
                        + k1.max_chunks(emax) * k1.MAX_SLICE)
    assert smem <= k1.SMEM_DEFAULT <= k1.SMEM_LIMIT


@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed", "reddit"])
def test_paper_graph_forward_rows_are_not_split(name):
    """Every forward row of the paper's synthetic graphs (destinations
    drawn uniformly; ``graph/datasets.py``) holds at most T slots of its
    aggregation layout at tile 128, so it sums bit for bit as one in-order
    fold.  The destinations are drawn as the generator draws them (after
    the sources' uniforms)."""
    spec = GRAPHS[name]
    rng = np.random.default_rng(spec.seed)
    rng.random(spec.num_edges)                  # the sources' draws
    dst = rng.integers(0, spec.num_vertices, size=spec.num_edges)
    in_deg = np.bincount(dst, minlength=spec.num_vertices)
    per_block = np.bincount(dst // 128)
    emax = max(8, -(-int(per_block.max()) // 8) * 8)
    assert in_deg.max() <= k1.split_threshold(emax)


@pytest.fixture(scope="module")
def hub():
    """The hub-row graph in both packages: source 0 feeds destinations
    1..3000, and 2,000 other edges join random pairs."""
    rng = np.random.default_rng(21)
    src = np.concatenate([np.zeros(HUB_FANOUT, np.int64),
                          rng.integers(1, HUB_V, HUB_OTHER)])
    dst = np.concatenate([np.arange(1, HUB_FANOUT + 1),
                          rng.integers(0, HUB_V, HUB_OTHER)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return (jgraph_from_coo(jnp.asarray(src, jnp.int32),
                            jnp.asarray(dst, jnp.int32), HUB_V),
            graph_from_coo(src, dst, HUB_V, device="cpu"))


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """The cuda tier with its device check lifted: K1's wrapper then gets
    CPU tensors and runs its plain version inside ``SegAgg``."""
    def check(backend, x):
        assert backend in ("torch", "cuda")
    monkeypatch.setattr(ops, "_check_tier", check)


def test_hub_graph_transposed_layout_splits_the_hub(hub):
    """K1's backward layout of the hub graph holds the hub as one row of
    3,000 slots, past its T, so the kernel folds it as chunks."""
    _, tg = hub
    bg = dataflow.block_graph_arrays(tg.src.numpy(), tg.dst.numpy(),
                                     HUB_V, TILE, transpose_rows=HUB_V)
    t = bg.transposed
    lengths = (t.dstl[0][t.mask[0] != 0]).bincount(minlength=TILE)
    assert int(lengths[0]) == HUB_FANOUT > k1.split_threshold(t.emax)
    items = k1.chunk_plan(lengths.tolist(), t.emax)
    hub = [it for it in items if it[0] == 0]
    assert len(hub) > 1 and all(o >= 0 for *_, o in hub)


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layers,width", [(1, 8), (2, 4), (3, 2)])
def test_hub_graph_x_gradient_matches_reference(hub, cuda_tier_on_cpu,
                                                monkeypatch, op, weighted,
                                                layers, width):
    """The x gradient of ``layers`` aggregations over the hub graph,
    through K1's Function over the blocked layout and its transposed one
    (the hub row split on a card) -- one fold forward and one backward a
    layer -- equals ``jax.grad`` of the reference's ``aggregate`` stacked
    as deep."""
    folds = {"fwd": 0, "bwd": 0}
    fold = k1._fold

    def spy(*args, backward=False, **kw):
        folds["bwd" if backward else "fwd"] += 1
        return fold(*args, backward=backward, **kw)
    monkeypatch.setattr(k1, "_fold", spy)
    jg, tg = hub
    rng = np.random.default_rng(layers * 10 + width)
    x = rng.standard_normal((HUB_V, width)).astype(np.float32)
    cot = rng.standard_normal((HUB_V, width)).astype(np.float32)
    w = rng.random(tg.num_edges).astype(np.float32) if weighted else None
    layout = dataflow.block_graph_arrays(tg.src.numpy(), tg.dst.numpy(),
                                         HUB_V, TILE, transpose_rows=HUB_V)

    def jloss(xx):
        for _ in range(layers):
            xx = jaggregate(jg, xx, op=op, backend="xla",
                            edge_weight=None if w is None
                            else jnp.asarray(w))
        return jnp.sum(xx * cot)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_()
    h = xt
    for _ in range(layers):
        h = aggregate(tg, h, op=op, backend="cuda", layout=layout,
                      edge_weight=None if w is None else torch.from_numpy(w))
    (got,) = torch.autograd.grad((h * torch.from_numpy(cot)).sum(), [xt])
    assert_allclose_dtype(got.numpy(), want)
    assert folds == {"fwd": layers, "bwd": layers}
