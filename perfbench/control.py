"""The control of the comparison that decides ``correct``:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--batches N]

The reference computed in bfloat16, the precision below the float32 the
configurations state, is put in the program's place: its top-k answers
to the run's sampled queries are judged by ``perfbench/check.py``
against the float32 reference, on the docs a run of the cell at that
seed judges (for a live cell: the initial corpus with ``--batches``
batches of each writer and all their deletes applied, force-merged,
then the last batch).  One JSON line a seed gives the gap against the
configuration's limit; the control has to come out over it.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from perfbench import check, manifest, run, workload  # noqa: E402
from perfbench.corpus import draw_corpus, rng_for  # noqa: E402
from perfbench.reference.bm25 import Index, Scorer  # noqa: E402


def control_gap(cell: dict, seed: int, batches: int = 100,
                device: str = "cpu") -> dict:
    cfg, mix = cell["config"], cell["mix"]
    gen = cfg["generator"]
    k = int(mix["per_page"])
    corp = draw_corpus(seed, int(cfg["docs"]), gen)
    queries = workload.make_queries(seed, mix, corp, gen)
    sample = sorted(rng_for(seed, workload.SAMPLE).choice(
        len(queries), size=min(int(mix["check_queries"]), len(queries)),
        replace=False).tolist())
    if mix.get("writers"):
        res = {"writes": [], "deletes": []}
        for w in range(mix["writers"]):
            plan = workload.writer_plan(seed, w, mix["writers"], corp.n_docs,
                                        mix, gen, batches)
            for b, batch in enumerate(plan):
                res["writes"].append([w, b, 0.0, 0.0, 200])
                res["deletes"].extend([w, b, d, 0.0, 0.0, 200]
                                      for d in batch.deletes)
        live, _deleted = run.live_state(seed, corp, res, mix, gen)
        last = workload.final_batch(seed, int(mix["write_batch"]), gen)
        for j, doc_id in enumerate(last.ids):
            live[doc_id] = (last.passages, j)
        ids, words, starts, srcs = run.assemble(live)
        fresh = set(last.ids)
        merged = np.array([d not in fresh for d in ids])
    else:
        ids = [f"d{i}" for i in range(corp.n_docs)]
        words, starts, srcs, merged = (corp.words, corp.starts, corp.sources,
                                       None)
    index = Index(words, starts, srcs, gen["vocab"], merged)
    ref = Scorer(index, "float32", device)
    ctl = Scorer(index, "bfloat16", device)
    reference, answers = {}, []
    for qi in sample:
        reference[qi] = ref.score(*queries[qi])
        docs, scores = ctl.top(*queries[qi], k)
        answers.append((qi, [(ids[d], float(s)) for d, s in zip(docs, scores)]))
    gaps = check.gaps(answers, reference, {d: i for i, d in enumerate(ids)},
                      k)
    return {"seed": seed, "answers": len(answers), "score_gap": max(gaps),
            "wrong": int(sum(g >= check.WRONG for g in gaps)),
            "limit": cfg["limits"]["score_gap"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=100)
    opts = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = manifest.cell(ROOT, opts.workload)
    for seed in (int(s) for s in opts.seeds.split(",")):
        got = control_gap(cell, seed, opts.batches, device)
        print(json.dumps(dict(got, device=device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
