"""The comparison that decides ``correct``: every answer the timed calls
returned, against the plain reference over the same rows.

kNN (``knn_numbers``):

* ``bad_answers``: answers that are malformed: a row missing or of the
  wrong width, an id outside the corpus or repeated within its row, a
  distance that is not finite, or distances not in ascending order.
* ``dist_err``: the widest gap between a distance the program returned and
  the reference's float64 distance of the id it returned beside it.
* ``rank_gap``: for each answer, the reference's distances of the returned
  ids, sorted, against the reference's own k smallest; the widest gap by
  which a returned neighbour lies beyond the true one of its rank.  Near
  ties may swap: they move this number by a rounding, a wrong neighbour by
  the gap between neighbours.

Range (``range_numbers``): ``bad_answers`` (a call's hit lists missing,
or a list with an id outside the corpus or repeated) and ``hit_margin``,
the widest distance from the threshold of a row in one hit list but not
the other (0 where the lists agree).

Each number is held to a limit of the cell's own (``portbench/limits``):
the number passes when it is at most its limit.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def _rows_per_block(ref, n: int, d: int, budget_bytes: int) -> int:
    return max(1, budget_bytes // (n * ref.pair_bytes(d)))


def reference_knn(ref, corpus: torch.Tensor, queries: torch.Tensor, k: int,
                  budget_bytes: int) -> torch.Tensor:
    """(nq, k) float64: each query's k smallest reference distances,
    ascending.  ``corpus`` and ``queries`` are prepared float64 rows on one
    device."""
    n, d = corpus.shape
    step = _rows_per_block(ref, n, d, budget_bytes)
    out = []
    for lo in range(0, queries.shape[0], step):
        dist = ref.pairwise(queries[lo:lo + step], corpus)
        out.append(torch.topk(dist, min(k, n), dim=1, largest=False, sorted=True).values)
    return torch.cat(out)


def _malformed_knn(ids: np.ndarray, dists: np.ndarray, n: int) -> np.ndarray:
    bad = (ids < 0).any(1) | (ids >= n).any(1) | ~np.isfinite(dists).all(1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= (dists[:, 1:] < dists[:, :-1]).any(1)
    return bad


def knn_numbers(ref, corpus: torch.Tensor, pool: torch.Tensor, answers: list, k: int,
                budget_bytes: int = 1 << 30) -> dict:
    """``answers``: one ``(pool rows (b,), ids (b, k), dists (b, k))`` per
    call, as the calls returned them.  ``corpus`` and ``pool`` are the
    reference's prepared float64 rows on the device it runs on."""
    n, d = corpus.shape
    bad = 0
    rows, ids, dists = [], [], []
    for p, i, dd in answers:
        p = np.asarray(p)
        i = None if i is None else np.asarray(i)
        dd = None if dd is None else np.asarray(dd)
        if (i is None or dd is None or i.shape != (len(p), k) or dd.shape != (len(p), k)):
            bad += len(p)
            continue
        rows.append(p)
        ids.append(i.astype(np.int64))
        dists.append(dd.astype(np.float64))
    if not rows:
        return {"bad_answers": bad, "dist_err": float("inf"), "rank_gap": float("inf")}
    rows, ids, dists = np.concatenate(rows), np.concatenate(ids), np.concatenate(dists)
    malformed = _malformed_knn(ids, dists, n)
    bad += int(malformed.sum())
    keep = ~malformed
    rows, ids, dists = rows[keep], ids[keep], dists[keep]

    used, inverse = np.unique(rows, return_inverse=True)
    dev = corpus.device
    truth = reference_knn(ref, corpus, pool[torch.as_tensor(used, device=dev)], k, budget_bytes)
    dist_err, rank_gap = 0.0, 0.0
    step = max(1, budget_bytes // (8 * k * d))
    for lo in range(0, len(rows), step):
        sl = slice(lo, lo + step)
        i_dev = torch.as_tensor(ids[sl], device=dev)
        q_dev = pool[torch.as_tensor(rows[sl], device=dev)]
        got = ref.paired(q_dev, corpus[i_dev])  # (b, k) float64
        returned = torch.as_tensor(dists[sl], device=dev)
        dist_err = max(dist_err, float((returned - got).abs().max()))
        best = truth[torch.as_tensor(inverse[sl], device=dev)]
        rank_gap = max(rank_gap, float((torch.sort(got, dim=1).values - best).max()))
    return {"bad_answers": bad, "dist_err": dist_err, "rank_gap": rank_gap}


MIX = np.uint64(0x9E3779B97F4A7C15)  # odd: the ids' hash, summed per hit list


def _hit_lists(hits: list, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One call's hit lists as (malformed lists: an id outside ``[0, n)`` or
    repeated; list lengths; a digest of each list as a set: the wrapping sum
    of its ids' hashes, so that lists of the same ids in any order agree)."""
    lens = np.fromiter(map(len, hits), np.int64, len(hits))
    ids = np.fromiter(itertools.chain.from_iterable(hits), np.int64, int(lens.sum()))
    owner = np.repeat(np.arange(len(hits)), lens)
    bad = np.zeros(len(hits), bool)
    bad[owner[(ids < 0) | (ids >= n)]] = True
    key = np.sort(owner * (n + 2) + np.clip(ids, -1, n) + 1)
    bad[key[1:][key[1:] == key[:-1]] // (n + 2)] = True
    with np.errstate(over="ignore"):
        sums = np.concatenate([np.zeros(1, np.uint64), np.cumsum(ids.astype(np.uint64) * MIX, dtype=np.uint64)])
        ends = np.cumsum(lens)
        digest = sums[ends] - sums[ends - lens]
    return bad, lens, digest


def range_numbers(ref, corpus: torch.Tensor, pool: torch.Tensor, answers: list,
                  budget_bytes: int = 1 << 30) -> dict:
    """``answers``: one ``(pool rows (b,), thresholds (b,), hit lists)`` per
    call.  Answers to one (query, threshold) of the same length and digest
    are judged once (two different sets agree in both with odds of 2**-64),
    on the reference's device."""
    n, d = corpus.shape
    bad = 0
    keys, where = [], []  # per list: (pool row, threshold, length, digest); (call, list)
    for c, (p, ts, hits) in enumerate(answers):
        if hits is None or len(hits) != len(p):
            bad += len(p)
            continue
        malformed, lens, digest = _hit_lists(hits, n)
        bad += int(malformed.sum())
        ok = np.flatnonzero(~malformed)
        keys.append(np.stack([np.asarray(p, np.int64)[ok].astype(np.uint64),
                              np.asarray(ts, np.float64)[ok].view(np.uint64),
                              lens[ok].astype(np.uint64), digest[ok]], axis=1))
        where.append(np.stack([np.full(len(ok), c), ok], axis=1))
    if not keys:
        return {"bad_answers": bad, "hit_margin": 0.0}
    keys, first = np.unique(np.concatenate(keys), axis=0, return_index=True)
    where = np.concatenate(where)[first]  # rows sorted by pool row
    rows = keys[:, 0].astype(np.int64)
    thresholds = keys[:, 1].view(np.float64)
    distinct = np.unique(rows)
    step = max(1, _rows_per_block(ref, n, d, budget_bytes) // 4)
    dev = corpus.device
    margin = 0.0
    for lo in range(0, len(distinct), step):
        block = distinct[lo:lo + step]
        dist = ref.pairwise(pool[torch.as_tensor(block, device=dev)], corpus)
        a, b = np.searchsorted(rows, [block[0], block[-1] + 1])
        for c0 in range(a, b, step):
            part = np.arange(c0, min(c0 + step, b))
            lists = [np.asarray(answers[c][2][j], np.int64) for c, j in where[part]]
            q = dist[torch.as_tensor(np.searchsorted(block, rows[part]), device=dev)]
            t = torch.as_tensor(thresholds[part], dtype=q.dtype, device=dev)[:, None]
            got = torch.zeros(q.shape, dtype=torch.bool, device=dev)
            owner = np.repeat(np.arange(len(part)), [len(h) for h in lists])
            got[torch.as_tensor(owner, device=dev),
                torch.as_tensor(np.concatenate([np.empty(0, np.int64), *lists]), device=dev)] = True
            wrong = got != (q <= t)
            if bool(wrong.any()):
                margin = max(margin, float((q - t).abs()[wrong].max()))
    return {"bad_answers": bad, "hit_margin": margin}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}).  A
    number without a limit, or a limit without a number, fails."""
    shown = {}
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        shown[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, shown
