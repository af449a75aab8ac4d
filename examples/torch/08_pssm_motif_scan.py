"""Position-specific scoring on the card: build a PSSM from motif instances,
scan a pool.

A PSSM (the PSI-BLAST / MEME model) scores each profile position with its
own per-symbol row, additive over the reference's single match/mismatch
rule. On the card the profile rides the one-vs-many kernel as its scoring
table. The port's twin of examples/08_pssm_motif_scan.py.

    python examples/torch/08_pssm_motif_scan.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from versalignlib_tpu_torch import pad_and_encode, profile_search, pssm_from_sequences

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

rng = np.random.default_rng(7)
motif = "TATAAAGGCGCC"

# 1. Build a log-odds profile from (noisy) aligned motif instances.
instances = []
for _ in range(40):
    s = list(motif)
    s[rng.integers(0, len(s))] = "ACGT"[rng.integers(0, 4)]
    instances.append("".join(s))
pssm = pssm_from_sequences(pad_and_encode(instances))
print(f"profile: {pssm.shape[0]} positions x {pssm.shape[1]} symbols, "
      f"consensus T at pos 0 scores {pssm[0, 2]}")

# 2. Plant the motif in a random pool and scan.
pool = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(64)]
planted = [5, 41]
for i in planted:
    pool[i] = pool[i][:20] + motif + pool[i][20 + len(motif):]
scores, idx = profile_search(pssm, pool, k=3, device=device)
print("top hits:", [(int(i), int(s)) for i, s in zip(idx, scores)])
assert set(planted) <= set(int(i) for i in idx[:3])

# 3. Multi-profile mode: several profiles against the pool in ONE dispatch.
shuffled = pssm[::-1].copy()
results = profile_search([pssm, shuffled], pool, k=2, device=device)
for name, (s, i) in zip(("motif", "reversed"), results):
    print(f"{name}: best pool entry {int(i[0])} score {int(s[0])}")

# 4. WHERE the motif sits: hits carry (end_row, end_col) from the search
# kernel's argmax fold; alignments=True adds the traceback.
hits = profile_search(pssm, pool, k=3, hits=True, alignments=True, device=device)
for h in hits:
    a = h.alignment
    print(f"entry {h.index}: score {h.score}, ref span "
          f"[{a.ref_start}, {h.end_col}], profile span "
          f"[{a.read_start}, {h.end_row}], cigar {a.cigar}")
assert all(h.alignment for h in hits)
assert hits[0].index in planted and hits[0].alignment.ref_start == 20
