"""MultiGrid cell-type constants and encodings.

The cell-type indices deliberately match the MiniGrid OBJECT_TO_IDX table the
reference uses (reference: envs/multigrid/multigrid.py + gym_minigrid), so the
(W, H, 3) uint8 level encodings produced here are byte-compatible with the
reference's ``Grid.encode()`` output (type, color, state channels).
"""

import numpy as np

# Object type indices (== gym_minigrid OBJECT_TO_IDX).
UNSEEN = 0
EMPTY = 1
WALL = 2
FLOOR = 3
DOOR = 4
KEY = 5
BALL = 6
BOX = 7
GOAL = 8
LAVA = 9
AGENT = 10

# Color indices (== gym_minigrid COLOR_TO_IDX).
RED, GREEN, BLUE, PURPLE, YELLOW, GREY = 0, 1, 2, 3, 4, 5

# Per-object default encode color (reference objects: Wall=grey, Goal=green,
# Lava=red, Floor=blue; empty/unseen encode color 0).
# numpy, so importing this module allocates nothing on a device; the engine
# copies the tables to its device where it needs them.
TYPE_COLOR = np.array(
    [0, 0, GREY, BLUE, BLUE, BLUE, BLUE, BLUE, GREEN, RED, 0],
    dtype=np.uint8,
)

# Actions (reference: multigrid.py MultiGridEnv.Actions).
LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE = 0, 1, 2, 3, 4, 5, 6
NUM_ACTIONS = 7

# Direction unit vectors, (dx, dy); dir 0=+x(right), 1=+y(down), 2=-x, 3=-y.
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int32)

# Cells an agent may walk onto (goal/lava terminate instead of moving).
WALKABLE = np.zeros(11, dtype=np.bool_)
WALKABLE[[EMPTY, FLOOR]] = True
WALKABLE.setflags(write=False)
