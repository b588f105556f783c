"""Object taxonomy and part-class symmetry tables (the port's copy of
constants.py).

The object categories (reference gapartnet/misc/info.py), per-class
symmetry types (reference gapartnet.yaml:34) and the padded orbit table the
NPCS loss takes its minimum over.
"""

import math

import numpy as np

OBJECT_NAME2ID = {
    # seen category
    "Box": 0,
    "Remote": 1,
    "Microwave": 2,
    "Camera": 3,
    "Dishwasher": 4,
    "WashingMachine": 5,
    "CoffeeMachine": 6,
    "Toaster": 7,
    "StorageFurniture": 8,
    "AKBBucket": 9,
    "AKBBox": 10,
    "AKBDrawer": 11,
    "AKBTrashCan": 12,
    "Bucket": 13,
    "Keyboard": 14,
    "Printer": 15,
    "Toilet": 16,
    # unseen category
    "KitchenPot": 17,
    "Safe": 18,
    "Oven": 19,
    "Phone": 20,
    "Refrigerator": 21,
    "Table": 22,
    "TrashCan": 23,
    "Door": 24,
    "Laptop": 25,
    "Suitcase": 26,
}

# part class names (the trainer's per-class metric names)
PART_ID2NAME = {
    0: "others",
    1: "line_fixed_handle",
    2: "round_fixed_handle",
    3: "slider_button",
    4: "hinge_door",
    5: "slider_drawer",
    6: "slider_lid",
    7: "hinge_lid",
    8: "hinge_knob",
    9: "revolute_handle",
}

# Per part class (0..9): symmetry type index (reference gapartnet.yaml:34).
SYMMETRY_INDICES = (0, 1, 3, 3, 2, 0, 3, 2, 4, 1)

# Orbit sizes per symmetry type: types 0/1/2 have 2 matrices, type 3 has 12
# z-rotations, type 4 has 12 z-rotations + 12 improper counterparts.
MAX_SYMMETRY_ORBIT = 24


def _rot_z(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    # row-vector convention: p' = p @ M
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float64)


def _rot_z_improper(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[s, c, 0.0], [c, -s, 0.0], [0.0, 0.0, -1.0]], dtype=np.float64)


def build_symmetry_orbits() -> np.ndarray:
    """Orbit matrix table, shape (5, MAX_SYMMETRY_ORBIT, 3, 3) float32.

    Type 0: {I, I}                            (no symmetry; duplicated identity)
    Type 1: {I, R_z(pi)}                      (180-degree z rotation)
    Type 2: {I, diag(-1, 1, -1)}              (180-degree y rotation)
    Type 3: {R_z(k*pi/6) : k=0..11}           (12-fold z rotation)
    Type 4: type 3 plus 12 improper elements  (z rotation * mirror)

    Orbits shorter than MAX_SYMMETRY_ORBIT are padded by repeating their first
    element (the identity), which leaves the min-over-orbit NPCS loss unchanged.
    """
    eye = np.eye(3, dtype=np.float64)
    orbits = [
        [eye, eye],
        [eye, _rot_z(math.pi)],
        [eye, np.diag([-1.0, 1.0, -1.0])],
        [_rot_z(k * math.pi / 6) for k in range(12)],
        [_rot_z(k * math.pi / 6) for k in range(12)]
        + [_rot_z_improper(k * math.pi / 6) for k in range(1, 13)],
    ]
    table = np.zeros((len(orbits), MAX_SYMMETRY_ORBIT, 3, 3), dtype=np.float32)
    for t, orbit in enumerate(orbits):
        m = len(orbit)
        table[t, :m] = np.stack(orbit)
        table[t, m:] = orbit[0]
    return table


SYMMETRY_ORBITS = build_symmetry_orbits()
