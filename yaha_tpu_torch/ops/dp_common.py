"""DP constants shared by the kernels' wrappers, their plain versions and
the backtrack walk.

The port's copy of the constants of yaha_tpu/ops/dp_common.py; the same
values are in csrc/sw_cells.cuh.
"""
DP_WORST = -(0x7FFFFF00)

# Op codes (int8) of the backtrack planes.
OP_UNKNOWN = 0
OP_MATCH = 1
OP_REPLACE = 2
OP_INSERT = 3
OP_DELETE = 4

# Packed-backtrack bits above the op (bits 0-2): "delete run continues one
# cell left" and "insert run continues up the chain".
BT_CD = 8
BT_CF = 16
