"""The KITTI depth metrics of a directory of predictions (the JAX
repository's ``tools/eval_kitti.py``, reference new_multi/my_eval.py:35-108
and the records line of new_multi/train5.py:113-114)::

    python -m cycle_depth_estimation_tpu_torch.tools.eval_kitti \\
        --gt_dir <groundtruth_depth> --pred_dir preds/ [--records records.txt]

Prints a header line of the metric names and a line of their values, and
with ``--records`` appends ``{"t": <unix time>, <metric>: <value>, …}`` as
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    from ..utils.metrics import DEPTH_METRIC_NAMES, eval_depth_dirs

    p = argparse.ArgumentParser()
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--records", default=None,
                   help="append the results to this records file")
    a = p.parse_args(argv)
    metrics = eval_depth_dirs(a.gt_dir, a.pred_dir)
    print(",".join(f"{k:>10}" for k in DEPTH_METRIC_NAMES))
    print(",".join(f"{metrics[k]:10.4f}" for k in DEPTH_METRIC_NAMES))
    if a.records:
        with open(a.records, "a") as fh:
            fh.write(json.dumps({"t": time.time(), **metrics}) + "\n")
    return metrics


if __name__ == "__main__":
    main()
