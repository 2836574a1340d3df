"""Time the run6 forms of the PyTorch port's fused-round kernel of one
checkout, with that checkout's own ``chip_smoke.check_kernel``, so that two
commits can be compared in turns in one call on one card:

    for r in parent . . parent; do python3 scripts/torch_kernel_ab.py $r; done

``parent`` is an unpacked ``git archive`` of the other commit. Needs one
NVIDIA GPU; builds the checkout's kernel, builds the NC run6 domain of
``chip_smoke.build_domain`` (seed 0) and prints one line ``AB {...}`` with
the kernel's ms per form at 8000 × 374.
"""

import json
import sys
import time

root = sys.argv[1]
sys.path.insert(0, root)
import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs  # noqa: E402
from genie_tpu_torch.graphs.build import build_station_graph  # noqa: E402
from genie_tpu_torch.ops.segment import aggregation_weights  # noqa: E402

t0 = time.time()
cs.build_kernels()
cfg = cs.run6_config()
ctx, _ = cs.build_domain(cfg, 0)
mask = torch.ones(ctx.sta_cart.shape[0], dtype=torch.bool, device="cuda")
nbr, valid = build_station_graph(ctx.sta_cart, cfg.graph.k_sta_edges, mask)
out = cs.check_kernel(nbr, aggregation_weights(nbr, valid), 0)
recs = out[0] if isinstance(out, tuple) else out     # the run6 forms
print("AB " + json.dumps({"root": root, "forms": [r["form"] for r in recs],
                          "ms": [r["ms"] for r in recs],
                          "seconds": time.time() - t0}), flush=True)
