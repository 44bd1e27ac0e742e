"""The least bytes one fused bounce level moves, counted from what its live
lanes need, whatever implements it, and its roofline time.

A live lane reads its queue rows (origin 3, direction 3, active,
throughput; the time too where the scene moves) and writes the level's 13
output rows; a lane that hits a glossy surface reads its 3 fuzz rows.  A
launch reads the table once: a world-to-object 3x4 a primitive and the
light table (position, color, intensity, radius: 8 words a light).  Dead
lanes and the lanes of a stage width beyond the live ones are not counted:
a change to the queue shrink leaves this count alone."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM, HBM3 (data sheet)
WORD = 4
QUEUE_ROWS = 8
OUT_ROWS = 13
FUZZ_ROWS = 3
GEOM_WORDS = 12
LIGHT_WORDS = 8


def level_bytes(live: int, hits: int, glossy: bool, motion: bool = False) -> int:
    """Bytes the live lanes of one level need."""
    lane = (QUEUE_ROWS + int(motion) + OUT_ROWS) * WORD
    return live * lane + (hits * FUZZ_ROWS * WORD if glossy else 0)


def table_bytes(n_geoms: int, n_lights: int) -> int:
    return (n_geoms * GEOM_WORDS + n_lights * LIGHT_WORDS) * WORD


def roofline_s(total_bytes: float) -> float:
    return total_bytes / PEAK_BYTES_PER_S
