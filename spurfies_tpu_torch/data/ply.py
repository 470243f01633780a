"""PLY point-cloud IO (copy of ``spurfies_tpu/data/ply.py``; reference
spurfies/model/utils.py:59-88 load path, rend_util.py:219-237 save path) —
self-contained binary/ascii PLY codec, no plyfile dependency."""

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def load_ply(path: str):
    """Read vertex x/y/z (+red/green/blue if present).

    Returns (points [N,3] float32, colors [N,3] float32 in 0..255 or None).
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vertex = 0
        props = []
        in_vertex = False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((parts[2], _PLY_TO_NP[parts[1]]))

        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append(f.readline().split())
            arr = np.asarray(rows, dtype=np.float64)
            data = {name: arr[:, i] for i, (name, _) in enumerate(props)}
        else:
            endian = "<" if "little" in fmt else ">"
            dt = np.dtype([(name, endian + t) for name, t in props])
            raw = np.frombuffer(f.read(n_vertex * dt.itemsize), dtype=dt,
                                count=n_vertex)
            data = {name: raw[name] for name, _ in props}

    pts = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    cols = None
    if "red" in data:
        cols = np.stack(
            [data["red"], data["green"], data["blue"]], -1
        ).astype(np.float32)
    return pts, cols


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Write binary-little-endian PLY with optional uint8 colors."""
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, 0], colors[:, 1], colors[:, 2]
        )
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
