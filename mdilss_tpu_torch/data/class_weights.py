"""Per-class loss weights: the port's own copy of the tables in
mdilss_tpu/data/class_weights.py:19-52 (the numbers hard-coded in every
reference trainer, train_new_task_step2.py:121-135; w_c = 1 / ln(p_c + 1.1),
with the last, ignore, class 0), and of `compute_class_weights`
(class_weights.py:58-75), the offline computation of such a table
(cal_class_weights.py:58-69)."""
from __future__ import annotations

from typing import Iterable

import numpy as np

CLASS_WEIGHTS: dict[str, np.ndarray] = {
    "cityscapes": np.array(
        [
            2.8159904084894922, 6.9874672455551075, 3.7901719017455604, 9.94305485286704,
            9.77037625072462, 9.511470001589007, 10.310780572569994, 10.025305236316246,
            4.6341256102158805, 9.561389195953845, 7.869695292372276, 9.518873463871952,
            10.374050047877898, 6.662394711556909, 10.26054487392723, 10.28786101490449,
            10.289883605859952, 10.405463349170795, 10.138502340710136, 0.0,
        ],
        dtype=np.float32,
    ),
    "BDD": np.array(
        [
            3.6525147483016243, 8.799815287822142, 4.781908267406055, 10.034828238618045,
            9.5567865464289, 9.645099012085169, 10.315292989325766, 10.163473632969513,
            4.791692009441432, 9.556915153488912, 4.142994047786311, 10.246903827488143,
            10.47145010979545, 6.006704177894196, 9.60620532303246, 9.964959813857726,
            10.478333987902301, 10.468010534454706, 10.440929141422366, 0.0,
        ],
        dtype=np.float32,
    ),
    "IDD": np.array(
        [
            3.235635601598852, 6.76221624390441, 9.458242359884549, 9.446818215454014,
            9.947040673126763, 9.789672819856547, 9.476665808564432, 10.465565126694731,
            9.59189547383129, 7.637805282159825, 8.990899026692638, 9.26222234098628,
            10.265657138809514, 9.386517631614392, 8.357391489170013, 9.910382864314824,
            10.389977663948363, 8.997422571963602, 10.418070541191673, 10.483262606962834,
            9.511436923349441, 7.597725385711079, 6.1734896019878205, 9.787631041755187,
            3.9178330193378708, 4.417448652936843, 0.0,
        ],
        dtype=np.float32,
    ),
}


def compute_class_weights(label_maps: Iterable[np.ndarray], num_classes: int, *,
                          q: float = 1.1) -> np.ndarray:
    """w_c = 1 / ln(q + p_c) over the pixel frequencies p_c of the labels below
    `num_classes`; the last (ignore) class 0. float32."""
    counts = np.zeros(num_classes, dtype=np.float64)
    total = 0
    for lm in label_maps:
        lm = np.asarray(lm)
        valid = lm[lm < num_classes]
        counts += np.bincount(valid.reshape(-1), minlength=num_classes)
        total += valid.size
    w = 1.0 / np.log(q + counts / max(total, 1))
    w[num_classes - 1] = 0.0
    return w.astype(np.float32)
