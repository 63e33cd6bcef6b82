"""Extract posed RGB-D frames from ScanNet ``.sens`` streams.

    python -m cnrma_torch.tools.data_prepare.extract_posed_images \
        --scans_path data/scannet/scans \
        --output_path data/scannet/posed_images

A copy of the JAX package's ``tools/data_prepare/extract_posed_images.py``:
parses the binary .sens container (header + per-frame pose/color/depth
records) and writes ``{output_path}/{scene}/{id:05d}.jpg`` + ``.png``
(depth, mm) + ``.txt`` (camera-to-world pose) + a shared
``intrinsic.txt``, at most ``--max_frames`` frames a scene (an even
stride).  Pure-python struct parsing, no external SensorData dependency.

ROADMAP F17, kept for the layout on disk: ``intrinsic.txt`` holds the
*colour* camera's intrinsic, while the depth PNGs keep the ``.sens`` depth
size (640x480 in ScanNet, against 1296x968 colour); ``read_sens`` reads
the depth intrinsic and this writer drops it.  ``generate_tsdf`` then
projects the depth maps through the colour intrinsic.
"""

import argparse
import io
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
from PIL import Image

COMPRESSION_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                     2: "occi_ushort"}


def read_sens(path):
    with open(path, "rb") as f:
        version = struct.unpack("I", f.read(4))[0]
        strlen = struct.unpack("Q", f.read(8))[0]
        f.read(strlen)  # sensor name
        intrinsic_color = np.frombuffer(f.read(16 * 4), np.float32
                                        ).reshape(4, 4)
        f.read(16 * 4)  # extrinsic_color
        intrinsic_depth = np.frombuffer(f.read(16 * 4), np.float32
                                        ).reshape(4, 4)
        f.read(16 * 4)  # extrinsic_depth
        color_comp = struct.unpack("i", f.read(4))[0]
        depth_comp = struct.unpack("i", f.read(4))[0]
        color_w, color_h = struct.unpack("II", f.read(8))
        depth_w, depth_h = struct.unpack("II", f.read(8))
        depth_shift = struct.unpack("f", f.read(4))[0]
        num_frames = struct.unpack("Q", f.read(8))[0]
        frames = []
        for _ in range(num_frames):
            pose = np.frombuffer(f.read(16 * 4), np.float32).reshape(4, 4)
            f.read(8 + 8)  # timestamps
            color_bytes = struct.unpack("Q", f.read(8))[0]
            depth_bytes = struct.unpack("Q", f.read(8))[0]
            color = f.read(color_bytes)
            depth = f.read(depth_bytes)
            frames.append((pose, color, depth))
    return {"intrinsic_color": intrinsic_color,
            "intrinsic_depth": intrinsic_depth,
            "color_comp": COMPRESSION_COLOR[color_comp],
            "depth_comp": COMPRESSION_DEPTH[depth_comp],
            "depth_size": (depth_h, depth_w),
            "depth_shift": depth_shift,
            "frames": frames}


def extract(sens_path, out_dir, max_frames=300):
    os.makedirs(out_dir, exist_ok=True)
    data = read_sens(sens_path)
    frames = data["frames"]
    stride = max(1, (len(frames) + max_frames - 1) // max_frames)
    # F17: the colour intrinsic, though the depth PNGs keep the depth size
    np.savetxt(os.path.join(out_dir, "intrinsic.txt"),
               data["intrinsic_color"], fmt="%.6f", delimiter=" ")
    h, w = data["depth_size"]
    n = 0
    for i in range(0, len(frames), stride):
        pose, color, depth = frames[i]
        if not np.isfinite(pose).all():
            continue
        fid = str(n).zfill(5)
        if data["color_comp"] == "jpeg":
            with open(os.path.join(out_dir, fid + ".jpg"), "wb") as f:
                f.write(color)
        else:
            Image.open(io.BytesIO(color)).save(
                os.path.join(out_dir, fid + ".jpg"))
        if data["depth_comp"] == "zlib_ushort":
            d = np.frombuffer(zlib.decompress(depth),
                              np.uint16).reshape(h, w)
        else:
            d = np.frombuffer(depth, np.uint16).reshape(h, w)
        Image.fromarray(d).save(os.path.join(out_dir, fid + ".png"))
        np.savetxt(os.path.join(out_dir, fid + ".txt"), pose,
                   fmt="%.6f")
        n += 1
    print(os.path.basename(out_dir), f"{n} frames")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--scans_path", required=True,
                   help="dir of {scene}/{scene}.sens")
    p.add_argument("--output_path", required=True)
    p.add_argument("--max_frames", type=int, default=300)
    p.add_argument("--scenes", nargs="*", default=None)
    args = p.parse_args(argv)
    scenes = args.scenes or sorted(os.listdir(args.scans_path))
    for scene in scenes:
        sens = os.path.join(args.scans_path, scene, scene + ".sens")
        if os.path.isfile(sens):
            extract(sens, os.path.join(args.output_path, scene),
                    args.max_frames)


if __name__ == "__main__":
    main()
