"""Dataset-generation configuration (the port's copy of datagen/config.py).

Data tables (target part classes, object categories, per-category camera
position ranges, background color) extracted from the reference
dataset/render_tools/utils/config_utils.py:19-261 into render_config.json.

Note the reference's name drift: the datagen class list uses `hinge_handle`
where the network taxonomy (constants.PART_ID2NAME) uses `revolute_handle` —
both are part class index 9 (SURVEY.md "known quirks").
"""

import json
import os
from pathlib import Path

_HERE = Path(__file__).parent
_CFG = json.loads((_HERE / "render_config.json").read_text())

TARGET_GAPARTS = _CFG["TARGET_GAPARTS"]
PARTNET_OBJECT_CATEGORIES = _CFG["PARTNET_OBJECT_CATEGORIES"]
AKB48_OBJECT_CATEGORIES = _CFG["AKB48_OBJECT_CATEGORIES"]
PARTNET_CAMERA_POSITION_RANGE = _CFG["PARTNET_CAMERA_POSITION_RANGE"]
AKB48_CAMERA_POSITION_RANGE = _CFG["AKB48_CAMERA_POSITION_RANGE"]
BACKGROUND_RGB = _CFG["BACKGROUND_RGB"]

WIDTH = 800
HEIGHT = 800
# camera fov / clipping (render_utils.py:28-113)
FOV_X_DEG = 35.0
FOV_Y_DEG = 35.0
NEAR = 0.1
FAR = 100.0
MAX_INSTANCE_NUM = 1000  # gt encoding base (convert_rendered_into_input.py:36)
