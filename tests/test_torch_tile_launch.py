"""The tiled tracker's launch geometry (ops/_kernels.tile_launch) on the CPU.

tile_launch is plain Python: from the paths, the tile, the warps of a
block and the clusters of each size the card holds at once (on the card,
the occupancy query hc_track_tile_clusters) it picks the cluster a tile
runs on and the persistent grid.  H100 is what that query returned for the
tiled tracker's 16-warp blocks on an H100 (one block per SM, clusters
bound by the SMs of a GPC); IDEAL packs 132 SMs perfectly; H100_4W is the
query's answer for blocks of 4 warps (4 per SM).  The cases: the round's
one launch (240 tiles) and its last segment (98), a late segment of an
abort round (24, 29), one tile, tile 256, ragged last tiles, tiles of
fewer paths than a block's warps, and more tiles than the card holds.
"""

import pytest

from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import _kernels

H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
IDEAL = {c: 132 // c for c in range(1, 9)}
H100_4W = {1: 528, 2: 264, 3: 163, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62}


@pytest.mark.parametrize("paths, tile, warps, resident, expect", [
    (30_700, 128, 16, H100, (2, 132)),   # one launch at H = 100: 240 tiles
    (12_500, 128, 16, H100, (2, 132)),   # its last segment: 98 tiles
    (3_070, 128, 16, H100, (4, 96)),     # a late segment: 24 tiles
    (3_684, 128, 16, H100, (4, 116)),    # an abort chunk's 29 tiles
    (100, 128, 16, H100, (8, 8)),        # one ragged tile
    (30_700, 256, 16, H100, (4, 120)),   # tile 256: 120 tiles
    (3_070, 100, 16, H100, (3, 93)),     # 31 tiles, the last of 70 paths
    (614, 2, 16, H100, (1, 132)),        # a tile of fewer paths than warps
    (614, 7, 16, H100, (1, 88)),         # 88 tiles, the last of 5 paths
    (30_700, 32, 16, H100, (1, 132)),    # 960 tiles: more than fit at once
    (30_700, 128, 16, IDEAL, (2, 132)),
    (3_070, 128, 16, IDEAL, (5, 120)),
    (30_700, 128, 4, H100_4W, (8, 496)),
    (3_070, 128, 4, H100_4W, (8, 192)),
    (614, 7, 4, H100_4W, (2, 176)),
], ids=["one-launch", "last-segment", "late-segment", "abort-chunk",
        "one-tile", "tile256", "ragged", "tile2", "tile7", "many-tiles",
        "ideal-one-launch", "ideal-late-segment", "4w-one-launch",
        "4w-late-segment", "4w-tile7"])
def test_tile_launch(paths, tile, warps, resident, expect):
    cluster, grid = _kernels.tile_launch(paths, tile, warps, resident)
    assert (cluster, grid) == expect
    tiles = -(-paths // tile)
    cap = min(_kernels.MAX_CLUSTER, -(-tile // warps))
    # Whole clusters, at most the portable 8, no more warps than paths.
    assert 1 <= cluster <= cap and grid % cluster == 0
    # Never more clusters than tiles, nor than the card holds at once.
    assert 0 < grid // cluster <= min(tiles, resident[cluster])
    # The cluster is the larger of two: the size that gives each warp
    # about PATHS_PER_WARP paths a step, and the largest size under which
    # every tile is in flight at once (few tiles).
    per_warp = _kernels.PATHS_PER_WARP
    fit = [c for c in range(1, cap + 1) if resident[c] >= tiles]
    assert cluster >= max(fit, default=1)
    assert cluster == cap or -(-tile // (cluster * warps)) <= per_warp \
        or cluster in fit
    assert cluster in fit or cluster == 1 \
        or (cluster - 1) * warps * per_warp < tile
    # Either every tile is in flight, or the card holds all it can.
    assert grid == cluster * min(tiles, resident[cluster])


def test_tile_launch_refuses_what_no_card_runs():
    """No cluster size that fits: a RuntimeError (hc_track raises it, it
    never falls back); a bad tile: a ValueError."""
    with pytest.raises(RuntimeError, match="cluster"):
        _kernels.tile_launch(30_700, 128, 16, {c: 0 for c in range(1, 9)})
    with pytest.raises(ValueError):
        _kernels.tile_launch(30_700, 0, 16, H100)
