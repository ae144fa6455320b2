"""The map arena (counterpart of ``gslam_tpu/map``): fixed-capacity
structure-of-arrays stores of frames, points and observations on the
device."""

from gslam_tpu_torch.map.arena import (  # noqa: F401
    MapArena, add_observations, arena_stats, compact_arena,
    covisibility_matrix, covisibility_topk, cull_points, erase_frame,
    erase_points, frame_point_ids, insert_frame, insert_points, load_arena,
    make_arena, merge_arenas, save_arena,
)
