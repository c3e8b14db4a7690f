"""The matrix regimes every engine is tested on (test_kernels.py,
test_kernels_f64.py, test_models.py), in one place."""
import numpy as np

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.utils import synth

#: the modes whose prepare may reject a matrix (DIA's fill budget)
DIA_MODES = ("DIA_ROWS", "DIA_BF16")


def _one_heavy_row(m, n, seed):
    """Power-law rows plus one row holding ~30% of the nnz."""
    base = synth.power_law(m, n, 3.0, seed=seed)
    heavy_len = int(0.43 * base.nnz)  # 0.43 / 1.43 ~ 30% of the total
    cols = np.random.default_rng(seed).choice(n, size=heavy_len, replace=False)
    keep = base.rows != 7
    rows = np.r_[base.rows[keep], np.full(heavy_len, 7)]
    cols = np.r_[base.cols[keep], cols]
    vals = np.r_[base.vals[keep], np.random.default_rng(seed + 1).standard_normal(heavy_len)]
    return S.sort_coo(S.COOMatrix((m, n), rows, cols, vals))


MATRICES = {
    "uniform": synth.random_uniform(111, 97, 0.05, seed=1, val_scale=synth.np.float64(1.0)),
    "banded": synth.banded(128, 128, 7, fill=0.9, seed=2),
    "powerlaw": synth.power_law(200, 180, 4.0, seed=3),
    "diag": synth.diagonal(64),
    "empty_rows": synth.random_uniform(90, 90, 0.01, seed=4),
    "wide_rect": synth.banded(60, 700, 6, fill=0.9, seed=6),
    "tall_rect": synth.banded(700, 60, 6, fill=0.9, seed=7),
    "heavy_row": _one_heavy_row(300, 300, seed=8),
    # diagonal reach (150) past the 128-row slab alignment
    "wide_band": synth.banded(700, 700, 150, fill=0.9, seed=9),
}


