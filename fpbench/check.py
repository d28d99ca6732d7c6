"""The comparison that decides ``correct``.

Once the window has closed, a sample of the pool's queries drawn from the
seed (``check_queries`` of them, every one the window answered) is worked
out again by ``fpbench/reference/``: the query rows (for audio, the plain
encoder in float32 over the same int16 audio and weights) and the
catalogue (the benchmark's random rows, and for audio the source songs'
rows embedded again by the plain encoder, never the program's rows).
Every answer the window gave to a sampled query is then judged by two gaps,
in mean inner-product units:

  gap        the reference's best alignment score of the query, less the
             reference's score at the (song, offset) the program answered:
             how far the answer lies below the best;
  score_err  the program's reported score less the reference's score at its
             answer, in magnitude.

``answer_err``, the largest of both over every judged answer, is held to
the cell's limit (``fpbench/workloads/<cell>.json``), and ``failed``, the
queries with no answer, to 0.  The control is the reference put in the
program's place at the precision below the configuration's bfloat16:
fp8 (e4m3) operands in the encoder and the search.  It answers each
sampled query once (its answer to a query is the same every time the window
would send it), and is judged by the same gaps and the same ``verdict``,
which has to come out false.
"""

from __future__ import annotations

import numpy as np
import torch

from fpbench.reference import fpnet
from fpbench.reference.search import best_alignment, score_at


def reference_rows(cfg: dict, tr: dict, inputs, sample: np.ndarray, device, low: bool):
    """(catalogue [n_songs, C, d], queries [K, S, d]) float32 on ``device``
    as the reference (or, with ``low``, the control) works them out."""
    db = torch.tensor(inputs.catalogue, device=device)
    if tr["kind"] == "audio":
        n_src = tr["source_songs"]
        db[:n_src] = fpnet.embed_signals(inputs.source_audio, inputs.params, cfg, low=low)
        q = fpnet.embed_signals(torch.from_numpy(inputs.pool[sample]).to(device),
                                inputs.params, cfg, low=low)
    else:
        q = torch.tensor(inputs.pool[sample], device=device)
    return db, q


def judge(db, q, best, k, song, t, score):
    """(gap, score_err) of answers (song, t, score) to queries k."""
    trip = np.stack([k, song, t], axis=1)
    uniq, inv = np.unique(trip, axis=0, return_inverse=True)
    u = torch.from_numpy(uniq).to(q.device)
    ref = score_at(db, q[u[:, 0]], u[:, 1], u[:, 2]).double().cpu().numpy()[inv.reshape(-1)]
    gap = best.double().cpu().numpy()[k] - ref
    return gap, np.abs(score - ref)


def verdict(failed: int, answer_err: float, limits: dict) -> bool:
    """``correct``: every query answered, and no answer further than the
    limit from the reference."""
    return failed == 0 and answer_err <= limits["answer_err"]


def compare(cfg: dict, tr: dict, inputs, answers: dict, device, limits: dict,
            control: bool = False) -> dict:
    """The checks of one run's answers (and, with ``control``, the control's
    readings of the same queries)."""
    with fpnet.no_tf32():
        return _compare(cfg, tr, inputs, answers, device, limits, control)


def _compare(cfg, tr, inputs, answers, device, limits, control):
    P = len(inputs.pool)
    seen = np.zeros(P, bool)
    seen[answers["idx"]] = True
    sample = inputs.check[seen[inputs.check]][: tr["check_queries"]]
    pos = np.full(P, -1)
    pos[sample] = np.arange(len(sample))
    ok = answers["song"] >= 0
    sel = (pos[answers["idx"]] >= 0) & ok
    k = pos[answers["idx"][sel]]
    song = answers["song"][sel]
    t = np.rint(answers["time_s"][sel] / cfg["hop_size"]).astype(np.int64)
    db, q = reference_rows(cfg, tr, inputs, sample, device, low=False)
    best, _, _ = best_alignment(db, q)
    gap, err = judge(db, q, best, k, song, t, answers["score"][sel])
    failed = int((~ok).sum())
    answer_err = float(max(gap.max(initial=0.0), err.max(initial=0.0)))
    worst = None
    if len(k):
        w = int(np.argmax(np.maximum(gap, err)))
        _, bs, bt = best_alignment(db, q[k[w] : k[w] + 1])
        worst = {"query": int(sample[k[w]]), "truth": inputs.truth[sample[k[w]]].tolist(),
                 "answer": [int(song[w]), int(t[w]), float(answers["score"][sel][w])],
                 "ref_at_answer": float(best[k[w]]) - float(gap[w]),
                 "ref_at_truth": float(score_at(
                     db, q[k[w] : k[w] + 1],
                     *torch.from_numpy(inputs.truth[sample[k[w]]][:, None]).to(q.device))[0]),
                 "ref_best": [int(bs[0]), int(bt[0]), float(best[k[w]])]}
    out = {
        "checks": {
            "failed": {"value": failed, "limit": 0},
            "answer_err": {"value": answer_err, "limit": limits["answer_err"]},
        },
        "checked": [int(len(sample)), int(sel.sum())],
        "components": {"gap": float(gap.max(initial=0.0)),
                       "score_err": float(err.max(initial=0.0)), "worst": worst},
    }
    out["correct"] = verdict(failed, answer_err, limits)
    if control:
        cdb, cq = (reference_rows(cfg, tr, inputs, sample, device, low=True)
                   if tr["kind"] == "audio" else (db, q))
        c_score, c_song, c_t = best_alignment(cdb, cq, low=True)
        del cdb, cq
        c_song = c_song.cpu().numpy()
        c_ok = c_song >= 0
        kk = np.arange(len(sample))[c_ok]
        cgap, cerr = judge(db, q, best, kk, c_song[c_ok], c_t.cpu().numpy()[c_ok],
                           c_score.double().cpu().numpy()[c_ok])
        c_failed = int((~c_ok).sum())
        c_err = float(max(cgap.max(initial=0.0), cerr.max(initial=0.0)))
        out["control"] = {"correct": verdict(c_failed, c_err, limits), "failed": c_failed,
                          "answer_err": c_err, "gap": float(cgap.max(initial=0.0)),
                          "score_err": float(cerr.max(initial=0.0))}
    return out
