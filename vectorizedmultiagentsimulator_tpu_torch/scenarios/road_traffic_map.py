"""CPM-Lab map loading and reference-path construction for the
road_traffic scenario (reference ``vmas/scenarios/road_traffic.py:3151-3970``).

The port's own copy of the JAX package's module (numpy and ``xml.etree``
only), reading the port's own copy of the map.  The XML lanelet map is
parsed once, the 40 long-term reference-path loops are assembled from the
routing tables, and all paths and boundaries are padded to a common length
so that the scenario reads per-agent path data with one indexed read.

The routing tables (loops of lanelet ids, shared-boundary groups,
intersection/merge paths) are map data for the CPM-Lab layout.
"""
from __future__ import annotations

import pathlib
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

DEFAULT_MAP_PATH = str(
    pathlib.Path(__file__).parent.parent
    / "scenarios_data"
    / "road_traffic"
    / "road_traffic_cpm_lab.xml"
)

# ---------------------------------------------------------------------- #
# Routing tables (CPM-Lab map data; road_traffic.py:3724-3970)
# ---------------------------------------------------------------------- #
REFERENCE_LANELETS_LOOPS = [
    [4, 6, 8, 60, 58, 56, 54, 80, 82, 84, 86, 34, 32, 30, 28, 2],
    [1, 3, 23, 10, 12, 17, 43, 38, 36, 49, 29, 27],
    [64, 62, 75, 55, 53, 79, 81, 101, 88, 90, 95, 69],
    [40, 45, 97, 92, 94, 100, 83, 85, 33, 31, 48, 42],
    [5, 7, 59, 57, 74, 68, 66, 71, 19, 14, 16, 22],
    [41, 39, 20, 63, 61, 57, 55, 67, 65, 98, 37, 35, 31, 29],
    [3, 5, 9, 11, 72, 91, 93, 81, 83, 87, 89, 46, 13, 15],
]

PATH_TO_LOOP = {
    1: (1, 4), 2: (2, 1), 3: (3, 64), 4: (4, 42), 5: (5, 22), 6: (6, 39),
    7: (7, 15), 8: (1, 8), 9: (2, 10), 10: (3, 75), 11: (4, 45), 12: (5, 59),
    13: (6, 61), 14: (7, 5), 15: (1, 58), 16: (2, 17), 17: (3, 79),
    18: (4, 92), 19: (5, 68), 20: (6, 55), 21: (7, 11), 22: (1, 54),
    23: (2, 38), 24: (3, 88), 25: (4, 100), 26: (5, 19), 27: (6, 65),
    28: (7, 93), 29: (1, 82), 30: (2, 49), 31: (3, 95), 32: (4, 33),
    33: (5, 14), 34: (6, 35), 35: (7, 83), 36: (1, 86), 37: (6, 29),
    38: (7, 89), 39: (1, 32), 40: (1, 28),
}

PATH_INTERSECTION = [
    [11, 25, 13], [11, 26, 52, 37], [11, 72, 91], [12, 18, 14],
    [12, 17, 43, 38], [12, 73, 92], [39, 51, 37], [39, 50, 102, 91],
    [39, 20, 63], [40, 44, 38], [40, 45, 97, 92], [40, 21, 64],
    [89, 103, 91], [89, 104, 78, 63], [89, 46, 13], [90, 96, 92],
    [90, 95, 69, 64], [90, 47, 14], [65, 77, 63], [65, 76, 24, 13],
    [65, 98, 37], [66, 70, 64], [66, 71, 19, 14], [66, 99, 38],
]
PATH_MERGE_IN = [[34, 32], [33, 31], [35, 31], [36, 49]]
PATH_MERGE_OUT = [[6, 8], [5, 7], [5, 9], [23, 10]]

LANELETS_SHARE_SAME_BOUNDARIES = [
    [4, 3, 22], [6, 5, 23], [8, 7], [60, 59], [58, 57, 75], [56, 55, 74],
    [54, 53], [80, 79], [82, 81, 100], [84, 83, 101], [86, 85], [34, 33],
    [32, 31, 49], [30, 29, 48], [28, 27], [2, 1],
    [13, 14], [15, 16], [9, 10], [11, 12],
    [63, 64], [61, 62], [67, 68], [65, 66],
    [91, 92], [93, 94], [87, 88], [89, 90],
    [37, 38], [35, 36], [41, 42], [39, 40],
    [25, 18], [26, 17], [52, 43], [72, 73],
    [51, 44], [50, 45], [102, 97], [20, 21],
    [103, 96], [104, 95], [78, 69], [46, 47],
    [77, 70], [76, 71], [24, 19], [98, 99],
]


# ---------------------------------------------------------------------- #
# XML parsing (road_traffic.py:3151-3349)
# ---------------------------------------------------------------------- #
def _parse_point(element):
    x = float(element.find("x").text)
    y = float(element.find("y").text)
    return np.asarray([x, y], np.float32)


def _parse_bound(element):
    points = np.stack(
        [_parse_point(p) for p in element.findall("point")], axis=0
    )
    lm = element.find("lineMarking")
    return points, (lm.text if lm is not None else None)


def get_center_length_yaw_polyline(polyline: np.ndarray):
    center_points = (polyline[:-1] + polyline[1:]) / 2
    vecs = np.diff(polyline, axis=0)
    lengths = np.linalg.norm(vecs, axis=1)
    yaws = np.arctan2(vecs[:, 1], vecs[:, 0])
    return center_points, lengths, yaws, vecs


def _parse_lanelet(element) -> Dict:
    data = {
        "id": int(element.get("id")),
        "predecessor": [],
        "successor": [],
        "adjacent_left": None,
        "adjacent_right": None,
        "lanelet_type": None,
        "left_line_marking": None,
        "right_line_marking": None,
        "center_line_marking": "dashed",
    }
    for child in element:
        if child.tag == "leftBound":
            data["left_boundary"], data["left_line_marking"] = _parse_bound(
                child
            )
        elif child.tag == "rightBound":
            data["right_boundary"], data["right_line_marking"] = _parse_bound(
                child
            )
        elif child.tag == "predecessor":
            data["predecessor"].append(int(child.get("ref")))
        elif child.tag == "successor":
            data["successor"].append(int(child.get("ref")))
        elif child.tag == "adjacentLeft":
            data["adjacent_left"] = {
                "id": int(child.get("ref")),
                "drivingDirection": child.get("drivingDir"),
            }
        elif child.tag == "adjacentRight":
            data["adjacent_right"] = {
                "id": int(child.get("ref")),
                "drivingDirection": child.get("drivingDir"),
            }
        elif child.tag == "lanelet_type":
            data["lanelet_type"] = child.text
    data["center_line"] = (
        data["left_boundary"] + data["right_boundary"]
    ) / 2
    (
        data["center_line_center_points"],
        data["center_line_lengths"],
        data["center_line_yaws"],
        _,
    ) = get_center_length_yaw_polyline(data["center_line"])
    return data


def get_map_data(map_file_path: str = None) -> Dict:
    if map_file_path is None:
        map_file_path = DEFAULT_MAP_PATH
    tree = ET.parse(map_file_path)
    root = tree.getroot()
    lanelets = []
    intersection_info = []
    for child in root:
        if child.tag == "lanelet":
            lanelets.append(_parse_lanelet(child))
        elif child.tag == "intersection":
            for incoming in child.findall("incoming"):
                intersection_info.append(
                    {
                        "incomingLanelet": int(
                            incoming.find("incomingLanelet").get("ref")
                        ),
                        "successorsRight": int(
                            incoming.find("successorsRight").get("ref")
                        ),
                        "successorsStraight": [
                            int(s.get("ref"))
                            for s in incoming.findall("successorsStraight")
                        ],
                        "successorsLeft": int(
                            incoming.find("successorsLeft").get("ref")
                        ),
                    }
                )
    mean_lane_width = float(
        np.mean(
            np.linalg.norm(
                np.vstack([l["left_boundary"] for l in lanelets])
                - np.vstack([l["right_boundary"] for l in lanelets]),
                axis=1,
            )
        )
    )
    return {
        "lanelets": lanelets,
        "intersection_info": intersection_info,
        "mean_lane_width": mean_lane_width,
    }


# ---------------------------------------------------------------------- #
# Reference-path assembly (road_traffic.py:3714-3852)
# ---------------------------------------------------------------------- #
def _get_reference_lanelet_index(ref_path_id: int) -> List[int]:
    loop_index, starting_lanelet = PATH_TO_LOOP.get(ref_path_id, (None, None))
    if loop_index is None:
        return []
    loop = REFERENCE_LANELETS_LOOPS[loop_index - 1]
    i0 = loop.index(starting_lanelet)
    return loop[i0:] + loop[:i0]


def _cat_no_dup(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if np.linalg.norm(a[-1] - b[0]) < 1e-4:
        return np.concatenate([a, b[1:]], axis=0)
    return np.concatenate([a, b], axis=0)


def calculate_reference_path(lanelet_ids: List[int], map_data: Dict) -> Dict:
    left = right = left_shared = right_shared = None
    for lanelet in lanelet_ids:
        group = next(
            g for g in LANELETS_SHARE_SAME_BOUNDARIES if lanelet in g
        )
        lb = map_data["lanelets"][lanelet - 1]["left_boundary"]
        rb = map_data["lanelets"][lanelet - 1]["right_boundary"]
        lbs = map_data["lanelets"][group[0] - 1]["left_boundary"]
        rbs = map_data["lanelets"][group[-1] - 1]["right_boundary"]
        if left is None:
            left, right = lb, rb
            left_shared, right_shared = lbs, rbs
        else:
            if np.linalg.norm(left[-1] - lb[0]) < 1e-4:
                left = np.concatenate([left, lb[1:]], axis=0)
                left_shared = np.concatenate([left_shared, lbs[1:]], axis=0)
            else:
                left = np.concatenate([left, lb], axis=0)
                left_shared = np.concatenate([left_shared, lbs], axis=0)
            if np.linalg.norm(right[-1] - rb[0]) < 1e-4:
                right = np.concatenate([right, rb[1:]], axis=0)
                right_shared = np.concatenate([right_shared, rbs[1:]], axis=0)
            else:
                right = np.concatenate([right, rb], axis=0)
                right_shared = np.concatenate([right_shared, rbs], axis=0)

    center = (left + right) / 2
    is_loop = np.linalg.norm(center[0] - center[-1]) <= 1e-4
    vecs = np.diff(center, axis=0)
    lengths = np.linalg.norm(vecs, axis=1)
    vecs_normalized = vecs / lengths[:, None]
    yaw = np.arctan2(vecs[:, 1], vecs[:, 0])
    return {
        "reference_lanelets": lanelet_ids,
        "left_boundary": left,
        "right_boundary": right,
        "left_boundary_shared": left_shared,
        "right_boundary_shared": right_shared,
        "center_line": center,
        "center_line_yaw": yaw,
        "center_line_vec_normalized": vecs_normalized,
        "center_line_vec_mean_length": float(np.mean(lengths)),
        "is_loop": bool(is_loop),
    }


def get_reference_paths(map_data: Dict):
    all_paths = [
        calculate_reference_path(
            _get_reference_lanelet_index(i + 1), map_data
        )
        for i in range(len(PATH_TO_LOOP))
    ]
    intersection = [
        calculate_reference_path(p, map_data) for p in PATH_INTERSECTION
    ]
    merge_in = [calculate_reference_path(p, map_data) for p in PATH_MERGE_IN]
    merge_out = [
        calculate_reference_path(p, map_data) for p in PATH_MERGE_OUT
    ]
    return all_paths, intersection, merge_in, merge_out


# ---------------------------------------------------------------------- #
# Static padded tables (the reference keeps ragged python lists and fills
# per-env slices in a reset loop, road_traffic.py:1191-1277; here every
# path is padded once so per-agent data is a single gather by path_id)
# ---------------------------------------------------------------------- #
class PaddedPaths:
    """Stacked, padded reference-path tables.

    Attributes (numpy):
      center     [n_paths, P, 2]   center line + extension + last-point pad
      vec_norm   [n_paths, P, 2]   normalized segment vectors (last repeated)
      left       [n_paths, P, 2]   shared left boundary (last-point padded)
      right      [n_paths, P, 2]   shared right boundary (last-point padded)
      n_points   [n_paths]         true center-line point counts
      n_left     [n_paths]
      n_right    [n_paths]
      is_loop    [n_paths] bool
      entry      [n_paths, 2, 2]
      exit       [n_paths, 2, 2]
    """

    def __init__(self, paths: List[Dict], n_extend: int, max_points: int):
        n = len(paths)
        P = max_points
        self.center = np.zeros((n, P, 2), np.float32)
        self.vec_norm = np.zeros((n, P, 2), np.float32)
        self.left = np.zeros((n, P, 2), np.float32)
        self.right = np.zeros((n, P, 2), np.float32)
        self.n_points = np.zeros((n,), np.int32)
        self.n_left = np.zeros((n,), np.int32)
        self.n_right = np.zeros((n,), np.int32)
        self.is_loop = np.zeros((n,), bool)
        self.entry = np.zeros((n, 2, 2), np.float32)
        self.exit = np.zeros((n, 2, 2), np.float32)
        for i, p in enumerate(paths):
            c = p["center_line"]
            np_i = c.shape[0]
            self.n_points[i] = np_i
            self.center[i, :np_i] = c
            # Extend along the last direction (road_traffic.py:347-378)
            direction = c[-1] - c[-2]
            ext = c[-1] + (
                np.arange(1, n_extend + 1, dtype=np.float32)[:, None]
                * direction
            )
            n_ext_used = min(n_extend, P - np_i)
            self.center[i, np_i : np_i + n_ext_used] = ext[:n_ext_used]
            self.center[i, np_i + n_ext_used :] = ext[-1]

            v = p["center_line_vec_normalized"]
            self.vec_norm[i, : np_i - 1] = v
            self.vec_norm[i, np_i - 1 :] = v[-1]

            lb = p["left_boundary_shared"]
            self.n_left[i] = lb.shape[0]
            self.left[i, : lb.shape[0]] = lb
            self.left[i, lb.shape[0] :] = lb[-1]
            rb = p["right_boundary_shared"]
            self.n_right[i] = rb.shape[0]
            self.right[i, : rb.shape[0]] = rb
            self.right[i, rb.shape[0] :] = rb[-1]

            self.is_loop[i] = p["is_loop"]
            self.entry[i, 0] = lb[0]
            self.entry[i, 1] = rb[0]
            self.exit[i, 0] = lb[-1]
            self.exit[i, 1] = rb[-1]
