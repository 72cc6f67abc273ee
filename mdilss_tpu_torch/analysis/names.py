"""Per-domain class-name lists (Plot_Tsne_Notebook cell 7); the port's own copy
of mdilss_tpu/analysis/names.py.

Indices match the trainId label spaces of §2.2: Cityscapes/BDD 19 named
classes (+ index 19 = remapped ignore), IDD level3 26 (+ 26 = misc/ignore),
and the 28-class union space of dataset.py:173-207.
"""

CITY_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]

BDD_NAMES = list(CITY_NAMES)

IDD_L3_NAMES = [
    "road", "drivable fallback", "sidewalk", "non-drivable fallback",
    "person", "rider", "motorcycle", "bicycle", "autorickshaw", "car",
    "truck", "bus", "vehicle fallback", "curb", "wall", "fence",
    "guard rail", "billboard", "traffic sign", "traffic light", "pole",
    "obs-str-bar-fallback", "building", "bridge", "vegetation", "sky", "misc",
]

UNION_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle", "drivable fallback",
    "non-drivable fallback", "autorickshaw", "vehicle fallback", "curb",
    "guard rail", "billboard", "obs-str-bar-fallback", "bridge",
]

NAMES_BY_DATASET = {
    "cityscapes": CITY_NAMES,
    "BDD": BDD_NAMES,
    "IDD": IDD_L3_NAMES,
    "IDD_union": UNION_NAMES,
}
