"""Multi-device data parallelism over a mesh of cards.

The batch shards over the mesh's devices (every card of the process); each
shard runs the kernels on its own card and the only communication is the
trailing gather of results. With ``--device cpu`` the same code path runs
over 8 CPU shards. The port's twin of examples/05_multichip.py.

    python examples/torch/05_multichip.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from versalignlib_tpu_torch import Algorithm, AlignmentEngine
from versalignlib_tpu_torch.parallel import make_mesh
from versalignlib_tpu_torch.parallel.mesh import DATA_AXIS

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

mesh = make_mesh(8, device="cpu") if device == "cpu" else make_mesh()

rng = np.random.default_rng(0)
bases = np.array(list("ACGT"))
reads = ["".join(rng.choice(bases, size=100)) for _ in range(64)]
refs = ["".join(rng.choice(bases, size=120)) for _ in range(64)]
print(f"{len(reads)} pairs sharded over the mesh's {DATA_AXIS!r} axis")

engine = AlignmentEngine(mesh=mesh)
oracle = AlignmentEngine(backend="oracle", device="cpu")
scores = engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
single = oracle.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
print("sharded scores == single-host oracle:", bool(np.array_equal(scores, single)))
alns = engine.compute_alignments(Algorithm.NEEDLEMAN_WUNSCH, reads, refs)
want = oracle.compute_alignments(Algorithm.NEEDLEMAN_WUNSCH, reads, refs)
print("sharded NW alignments == single-host oracle:", alns == want)
print("best SW score:", int(scores.max()))
