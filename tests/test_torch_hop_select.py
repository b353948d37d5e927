"""The descent hops' suppression and selection, as the CUDA kernels do them,
held against the plain version on the CPU.

The hop kernels (``csrc/hop_common.cuh``) do not run the reference's
rounds. They put every lane's id into a hash table whose slot keeps the
id's lowest column and counts its candidate lanes, then scan the table:
an id whose lowest column is a beam lane is in the beam, a tombstoned id
is dropped, and every other id's lowest column is its one scored "owner"
lane, its count added to ``n_scored``. They key the beam and owner lanes
by one 64-bit (sim, column) key, split the keys among 16 warps that each
keep a top-B filtered against a lagging threshold and the beam's lowest
key, and merge the warps' lists in a tree. This file writes that algorithm in plain
torch and holds it, on random lanes with planted ties, against
``merge_topk`` / ``select_topk(dedup_ids=True)`` (what
``ref.descent_hop_ref`` runs) and ``ref.survivors``. The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them
bitwise against ``ref``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels.descent_score import ref  # noqa: E402
from repro_torch.knn.topk import merge_topk, select_topk  # noqa: E402
from repro_torch.types import NEG_INF, PAD_ID  # noqa: E402

WARPS = 16
MAX_LIST_BEAM = 512  # wider beams take the radix select (hop_common.cuh)
ABSENT = -(2 ** 63)  # the kernels' key 0, as a signed int64
SIMS = np.float32([0.0, -0.0, 0.125, 0.5, 1 / 3, 0.9, 1.0, NEG_INF])


def sim_keys(sims: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys in the kernels' order (``keys.cuh`` ``sim_key`` less
    2**63): high half the sim's order-preserving bits with -0.0 taken as
    +0.0, low half 0xFFFFFFFF - column; -inf is ABSENT."""
    b = (sims + 0.0).contiguous().view(torch.int32).to(torch.int64)
    hi = b ^ ((b >> 31) & 0x7FFFFFFF)
    key = hi * (1 << 32) + (0xFFFFFFFF - cols.to(torch.int64))
    return torch.where(sims == NEG_INF, ABSENT, key)


def key_parts(keys: torch.Tensor):
    """(column, sim) of int64 keys; ABSENT gives column -1 and -inf."""
    cols = (0xFFFFFFFF - (keys & 0xFFFFFFFF)).to(torch.int32)
    hi = (keys >> 32).to(torch.int32)
    sims = (hi ^ ((hi >> 31) & 0x7FFFFFFF)).view(torch.float32)
    absent = keys == ABSENT
    return torch.where(absent, -1, cols), torch.where(absent, NEG_INF, sims)


def hash_table(ids, B, rng) -> list:
    """The hash table of one query after every lane's insert, the lanes
    inserted in a random order (the kernel's threads race): open
    addressing over 1.5 L + 1 slots with the kernel's Fibonacci hash, each
    slot [id, lowest column, candidate lanes] or None."""
    L = len(ids)
    slots = L + L // 2 + 1
    tab = [None] * slots
    for col in rng.permutation(L):
        i = int(ids[col])
        if i == PAD_ID:
            continue
        h = (((i & 0xFFFFFFFF) * 2654435769) & 0xFFFFFFFF) * slots >> 32
        while tab[h] is not None and tab[h][0] != i:
            h = h + 1 if h + 1 < slots else 0
        if tab[h] is None:
            tab[h] = [i, col, 0]
        tab[h][1] = min(tab[h][1], col)
        tab[h][2] += col >= B
    return tab


def lowest_columns(ids, rng) -> dict:
    """{id: lowest column} from the hash table."""
    tab = [e for e in hash_table(ids, 0, rng) if e is not None]
    found = {e[0]: e[1] for e in tab}
    assert len(found) == len(tab)  # one slot per id
    return found


def topk_keys(keys: list, k: int) -> list:
    return sorted(keys, reverse=True)[:k] + [ABSENT] * max(0, k - len(keys))


def warp_top(keys: list, B: int, KP: int, low: int) -> list:
    """One warp over its slice: 32-key tiles filtered against the list's
    B-th key (and ``low``), buffered, and merged into the top-KP list when
    the buffer would overflow, as ``select_beam``."""
    lst, buf, thr = [ABSENT] * KP, [], low
    for t in range(0, len(keys), 32):
        keep = [x for x in keys[t:t + 32] if x > thr]
        if len(buf) + len(keep) > 32:
            lst = topk_keys(lst + buf, KP)
            thr, buf = max(lst[B - 1], low), []
        buf += keep
    return topk_keys(lst + buf, KP) if buf else lst


def radix_select(keys: list, B: int) -> list:
    """``select_beam<0>``, the kernels' selection for beams above 512
    lanes: the B-th largest key by 8 passes of 8 bits from the top (a
    histogram of the keys matching the digits found so far; the digit
    holding the rank sought), then the nonzero keys at or above it, each
    placed at its rank (the count of those above it); PAD slots after.
    Keys are the kernels' unsigned 64-bit keys, here as signed int64
    (ABSENT is unsigned 0)."""
    u = [k + 2 ** 63 for k in keys]  # unsigned order
    prefix = mask = 0
    need = B
    for shift in range(56, -1, -8):
        hist = [0] * 256
        for x in u:
            if x & mask == prefix:
                hist[(x >> shift) & 255] += 1
        above, d = 0, 255
        while d > 0 and above + hist[d] < need:
            above += hist[d]
            d -= 1
        prefix |= d << shift
        mask |= 255 << shift
        need -= above
    chosen = [x for x in u if x != 0 and x >= prefix]
    assert len(chosen) <= B
    out = [ABSENT] * B
    for x in chosen:
        out[sum(y > x for y in chosen)] = x - 2 ** 63
    return out


def kernel_select(beam_ids, beam_sims, cand_ids, cand_sims, B, rng,
                  dead=frozenset()):
    """The kernels' hop for one query from its beam (live ids or PAD) and
    scored candidate lanes, ids in ``dead`` tombstoned: (ids, sims,
    n_scored, rows read)."""
    lane_ids = np.concatenate([beam_ids, cand_ids])
    work, scored = [], 0
    for e in hash_table(lane_ids, B, rng):  # the scan of the slots
        if e is None or e[1] < B or e[0] in dead:
            continue
        scored += e[2]
        work.append(e[1])
    work = [work[j] for j in rng.permutation(len(work))]  # any order
    sims = np.concatenate([beam_sims, cand_sims])
    cols = np.array(list(range(B)) + work, dtype=np.int64)
    lane_sims = torch.from_numpy(sims[cols].astype(np.float32))
    keys = sim_keys(lane_sims, torch.from_numpy(cols))
    keys[:B] = torch.where(torch.from_numpy(beam_ids) == PAD_ID, ABSENT,
                           keys[:B])
    keys = keys.tolist()
    thr0 = min(keys[:B])
    low = thr0 - 1 if thr0 != ABSENT else ABSENT
    if B > MAX_LIST_BEAM:
        top = torch.tensor(radix_select(keys, B), dtype=torch.int64)
    else:
        KP = 32
        while KP < B:
            KP *= 2
        tiles = -(-len(keys) // 32)
        per = -(-tiles // WARPS)
        lists = [warp_top(keys[w * per * 32:(w + 1) * per * 32], B, KP, low)
                 for w in range(WARPS)]
        while len(lists) > 1:  # the tree: warp w merges warp w + half's
            half = len(lists) // 2
            lists = [topk_keys(lists[w] + lists[w + half], KP)
                     for w in range(half)]
        top = torch.tensor(lists[0][:B], dtype=torch.int64)
    col, sim = key_parts(top)
    ids = torch.where(col >= 0, torch.from_numpy(lane_ids)[col.clamp(min=0)
                                                           .long()], PAD_ID)
    return ids.to(torch.int32), sim, scored, len(work)


def random_query(rng, n, B, C, pad_beam=0.2, pad_cand=0.2):
    """A beam (distinct ids, PAD lanes -inf) and C candidate lanes drawn
    from few ids (duplicates, beam ids among them), every lane naming an id
    carrying that id's sim; sims from a small set, so they tie. Plus a set
    of tombstoned ids that no beam lane holds."""
    m = int(rng.integers(0, min(n, B) + 1))
    beam = np.full(B, PAD_ID, np.int32)
    beam[:m] = rng.choice(n, size=m, replace=False)
    beam = beam[rng.permutation(B)]
    if rng.random() < pad_beam:
        beam[:] = PAD_ID
    sim_of = rng.choice(SIMS[:-1], size=n)
    bsims = np.where(beam == PAD_ID, NEG_INF,
                     rng.choice(SIMS, size=B)).astype(np.float32)
    cand = rng.integers(0, n, size=C).astype(np.int32)
    cand[rng.random(C) < pad_cand] = PAD_ID
    csims = np.where(cand == PAD_ID, NEG_INF,
                     sim_of[np.maximum(cand, 0)]).astype(np.float32)
    dead = set(rng.choice(n, size=int(rng.integers(0, n // 4 + 1)),
                          replace=False).tolist()) - set(beam.tolist())
    return beam, bsims, cand, csims, frozenset(dead)


def reference(beam, bsims, cand, csims, B, dead=frozenset()):
    """merge_topk and select_topk(dedup_ids=True) over the lanes, with
    tombstoned candidates PAD / -inf as ``ref.gather_candidates`` makes
    them; and ``ref.survivors``' count."""
    gone = np.isin(cand, list(dead))
    cand = np.where(gone, PAD_ID, cand).astype(np.int32)
    csims = np.where(gone, NEG_INF, csims).astype(np.float32)
    ids = torch.from_numpy(np.concatenate([beam, cand]))[None]
    sims = torch.from_numpy(np.concatenate([bsims, csims]))[None]
    m_ids, m_sims = merge_topk(ids, sims, B)
    # select_topk over the lanes the reference masks (PAD and in-beam
    # candidates -inf), with winner-id retirement.
    masked = torch.where(ids == PAD_ID, NEG_INF, sims)
    in_beam = torch.from_numpy(np.isin(cand, beam[beam != PAD_ID]))
    masked[0, B:] = torch.where(in_beam, NEG_INF, masked[0, B:])
    r_sims, r_ids = select_topk(masked, ids, B, dedup_ids=True)
    r_ids = torch.where(r_sims == NEG_INF, PAD_ID, r_ids)
    scored = ref.survivors(torch.from_numpy(cand)[None],
                           torch.from_numpy(beam)[None]).sum()
    return m_ids[0], m_sims[0], r_ids[0], r_sims[0], int(scored)


def check(rng, n, B, C, **kw):
    beam, bsims, cand, csims, dead = random_query(rng, n, B, C, **kw)
    ids, sims, scored, rows = kernel_select(beam, bsims, cand, csims, B, rng,
                                            dead)
    m_ids, m_sims, r_ids, r_sims, r_scored = reference(beam, bsims, cand,
                                                       csims, B, dead)
    assert torch.equal(ids, m_ids) and torch.equal(sims, m_sims)
    assert torch.equal(ids, r_ids) and torch.equal(sims, r_sims)
    assert scored == r_scored
    live = cand[(cand != PAD_ID) & ~np.isin(cand, beam[beam != PAD_ID])
                & ~np.isin(cand, list(dead))]
    assert rows == len(np.unique(live)) <= scored


def test_key_order_is_merge_order():
    """Keys sort as (sim desc, column asc) over -inf, +-0.0 and equal sims
    in different columns, and decode to their column and sim."""
    rng = np.random.default_rng(0)
    sims = torch.from_numpy(rng.choice(SIMS, size=(30, 70)))
    cols = torch.arange(70).expand(30, 70)
    keys = sim_keys(sims, cols)
    order = torch.argsort(keys, dim=1, descending=True, stable=True)
    _, pos = torch.sort(sims, dim=1, descending=True, stable=True)
    live = torch.gather(sims, 1, pos) != NEG_INF
    assert torch.equal(order[live], pos[live])
    row = keys[0][sims[0] != NEG_INF]
    assert torch.unique(row).numel() == row.numel()
    col, sim = key_parts(keys)
    assert torch.equal(col[sims != NEG_INF], cols[sims != NEG_INF].int())
    assert torch.equal(sim, sims)  # -0.0 == 0.0 for torch.equal
    assert (keys[sims == NEG_INF] == ABSENT).all()


def test_hash_table_keeps_each_ids_lowest_column():
    rng = np.random.default_rng(1)
    for L in (1, 2, 7, 64, 1952):
        ids = rng.integers(-1, max(2, L // 3), size=L).astype(np.int32)
        got = lowest_columns(ids, rng)
        want = {}
        for col, i in enumerate(ids):
            if i != PAD_ID:
                want.setdefault(int(i), col)
        assert got == want


@pytest.mark.parametrize("B,C", [(1, 60), (5, 300), (32, 1920), (33, 200),
                                 (64, 1000), (513, 1500), (1024, 3000)])
def test_selection_matches_merge_topk(B, C):
    rng = np.random.default_rng(B * 1000 + C)
    for _ in range(6):
        check(rng, max(2, C // 4), B, C)


def test_selection_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=80, deadline=None, database=None)
    @given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 70),
           C=st.integers(0, 700), n=st.integers(1, 400),
           pad_beam=st.sampled_from([0.0, 0.5]),
           pad_cand=st.sampled_from([0.0, 0.3, 1.0]))
    def battery(seed, B, C, n, pad_beam, pad_cand):
        check(np.random.default_rng(seed), n, B, C, pad_beam=pad_beam,
              pad_cand=pad_cand)

    battery()


def test_radix_select_property():
    """The radix select keeps exactly the top B keys in order, over keys
    with shared high digits, absent (zero) keys and fewer present keys
    than B."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=80, deadline=None, database=None)
    @given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 300),
           B=st.integers(1, 300), absent=st.sampled_from([0.0, 0.3, 1.0]))
    def battery(seed, n, B, absent):
        rng = np.random.default_rng(seed)
        sims = torch.from_numpy(rng.choice(SIMS, size=n))
        sims[torch.from_numpy(rng.random(n) < absent)] = NEG_INF
        keys = sim_keys(sims, torch.from_numpy(rng.permutation(n))).tolist()
        B = min(B, n)  # the kernels select B of B + n_work >= B keys
        assert radix_select(keys, B) == topk_keys(
            [k for k in keys if k != ABSENT], B)

    battery()


def test_split_and_merge_of_partial_lists():
    """Top-B lists of any column split, merged pairwise, give the top-B of
    the whole: what the warps' tree relies on."""
    rng = np.random.default_rng(2)
    for _ in range(40):
        n = int(rng.integers(1, 400))
        keys = sim_keys(torch.from_numpy(rng.choice(SIMS, size=n)),
                        torch.from_numpy(rng.permutation(n))).tolist()
        B = int(rng.integers(1, 65))
        cuts = np.unique(np.concatenate(
            [[0, n], rng.integers(0, n + 1, size=int(rng.integers(0, 9)))]))
        parts = [topk_keys(keys[a:b], B) for a, b in zip(cuts, cuts[1:])]
        while len(parts) > 1:
            parts = [topk_keys(parts[i] + parts[i + 1], B)
                     if i + 1 < len(parts) else parts[i]
                     for i in range(0, len(parts), 2)]
        assert parts[0] == topk_keys(keys, B)


def test_beam_membership_matches_survivors():
    """A candidate is scored exactly when ``ref.survivors`` says so: its
    id is not PAD and its lowest column is not a beam lane."""
    rng = np.random.default_rng(3)
    for _ in range(30):
        B, C = int(rng.integers(1, 40)), int(rng.integers(0, 300))
        beam, _, cand, _, _ = random_query(rng, 50, B, C)
        low = lowest_columns(np.concatenate([beam, cand]), rng)
        mine = np.array([i != PAD_ID and low[int(i)] >= B for i in cand],
                        dtype=bool)
        want = ref.survivors(torch.from_numpy(cand)[None],
                             torch.from_numpy(beam)[None])[0].numpy()
        assert np.array_equal(mine, want)


def test_pad_and_neg_inf_outputs():
    """An all-PAD beam with all-PAD candidates, and a beam whose only live
    lane carries -inf: every output slot is PAD / -inf."""
    rng = np.random.default_rng(4)
    B = 8
    beam = np.full(B, PAD_ID, np.int32)
    bsims = np.full(B, NEG_INF, np.float32)
    cand = np.full(40, PAD_ID, np.int32)
    csims = np.full(40, NEG_INF, np.float32)
    ids, sims, scored, rows = kernel_select(beam, bsims, cand, csims, B, rng)
    assert (ids == PAD_ID).all() and (sims == NEG_INF).all()
    assert scored == 0 and rows == 0
    beam[3] = 5
    ids, sims, _, _ = kernel_select(beam, bsims, cand, csims, B, rng)
    assert (ids == PAD_ID).all() and (sims == NEG_INF).all()
    m_ids, m_sims = reference(beam, bsims, cand, csims, B)[:2]
    assert torch.equal(ids, m_ids) and torch.equal(sims, m_sims)
