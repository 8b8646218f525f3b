#!/usr/bin/env python3
"""Where the time of the ``sdc_scores`` score matrix goes, measured by kernel variants.

    python3 tools/scores_split.py [--tree .] [--seed 0] [--docs 10000037] [--reps 5]

Run on a CUDA card from the root of a checkout; ``--tree`` names the
checkout whose ``src/repro_torch`` is measured (another commit unpacked
beside this one, for example). It makes seeded random codes on the card
at the shapes ``chip_smoke.py`` times ``sdc_scores`` at (64 queries,
10,000,037 documents, code dim 128, n_levels 4, int8 and nibble-packed;
the work does not depend on the codes' values), then compiles variants
of the tree's ``sdc_scores.cu`` in which one part is cut out by text
substitution and times each whole call with CUDA events:

  full        the kernel as it is
  no-product  the code product skipped: one XOR of a row word and a
              query word per (query, document) pair, or per tile product
  no-store    every score computed, none written to the output (one
              compare per store keeps it live)
  neither     no product and no store

The cuts are one text edit each, for the kernel design the source holds
(the dp4a scan of PR 12, or the tile-product design that replaced it).
A variant's results are wrong by design; only its time is read. The
split follows: product = full - no-product, stores = full - no-store.
``full`` is timed first and last to show drift; each variant's registers
come from its build log.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from split_common import build_variants, card, register_lines, time_ms

ROOT = Path(__file__).resolve().parents[1]
Q, CODE_DIM, LEVELS = 64, 128, 4

# design: {cut: (pattern, replacement)}; the design is the one whose
# patterns are all in the source.
CUTS = {
    "dp4a": {
        "product": ("row_dot<PACKED>(a, b, qs + qq * R::QSTRIDE)",
                    "(int)(a[0] ^ (unsigned)qs[qq * R::QSTRIDE])"),
        "store": ("out[(size_t)(q0 + qq) * N + n] = s;",
                  "if (s == 1.2345f) out[(size_t)(q0 + qq) * N + n] = s;"),
    },
    "tile": {
        "product": ("mma_s8(acc[m][n], a, bq[n][ks]);",
                    "acc[m][n][0] ^= (int)(a[0] ^ bq[n][ks][0]);"),
        "store": ("*reinterpret_cast<float4*>(out + (size_t)(q0 + j) * ldo + n) = v;",
                  "if (v.x == 1.2345f) *reinterpret_cast<float4*>(out + (size_t)(q0 + j) * ldo"
                  " + n) = v;"),
    },
}


def variants(text: str) -> dict:
    for cuts in CUTS.values():
        if all(p in text for p, _ in cuts.values()):
            product, store = cuts["product"], cuts["store"]
            return {"full": [], "no-product": [product], "no-store": [store],
                    "neither": [product, store]}
    raise SystemExit("scores_split: the source holds none of the known designs")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=10_000_037)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("scores_split: no CUDA device")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.binarize_lib import pack_codes_nibbles
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdc import sdc
    from repro_torch.kernels.sdc.ref import doc_inv_norms

    device = torch.device("cuda:0")
    smi = card()
    print(f"[split] tree {tree} on {smi}", flush=True)

    source = Path(sdc._SCORES_SOURCE)
    cuts = variants(source.read_text())
    sources = build_variants(_build.build, source, cuts, _build.BUILD_DIR / "scores_split",
                             "scores_split")
    for name, src in sources.items():
        for kernel, line in register_lines(_build.library_path(src).with_suffix(".log"),
                                           r"sdc_scores_kernel"):
            if "registers" in line:
                args_ = kernel.split("sdc_scores_kernel")[1].split("EEv")[0]
                print(f"[split] build {name}: sdc_scores_kernel<{args_}>: {line}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    q = torch.randint(0, 2**LEVELS, (Q, CODE_DIM), generator=gen, device=device).to(torch.int8)
    d = torch.randint(0, 2**LEVELS, (args.docs, CODE_DIM), generator=gen, device=device)
    d = d.to(torch.int8)
    inv = doc_inv_norms(d, LEVELS)
    calls = {"int8": (q, d, inv, dict(n_levels=LEVELS, packed=False)),
             "packed": (q, pack_codes_nibbles(d), inv, dict(n_levels=LEVELS, packed=True))}
    del d
    torch.cuda.synchronize()

    names = list(sources)
    times = {}
    for i, name in enumerate(names + [names[0]]):
        sdc._SCORES_SOURCE = sources[name]
        sdc._scores_lib.cache_clear()
        key = name if i < len(names) else f"{name} again"
        times[key] = {}
        for tag, (qq, dd, ii, kw) in calls.items():
            times[key][tag] = time_ms(lambda: sdc.sdc_scores(qq, dd, ii, **kw), args.reps)
        print(f"[split] {key:12s} " + "  ".join(f"{t} {ms:.3f} ms" for t, ms in times[key].items()),
              flush=True)
    for tag in calls:
        t = {v: times[v][tag] for v in names}
        print(f"[split] {tag} Q={Q} N={args.docs} D={CODE_DIM}: full {t['full']:.3f} ms; product "
              f"{t['full'] - t['no-product']:.3f}, stores {t['full'] - t['no-store']:.3f}, "
              f"neither {t['neither']:.3f} ms on {smi}", flush=True)


if __name__ == "__main__":
    main()
