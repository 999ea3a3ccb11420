"""Video -> frame extraction.

Capability parity with reference ``vid2img.py`` (ffmpeg subprocess -> PNGs).
Prefers the ffmpeg binary when present (identical behavior); otherwise falls
back to cv2.VideoCapture / imageio decoding so the pipeline has no hard
external-binary dependency.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import shutil
import subprocess


def video_to_images(vid_file: str, img_folder: str | None = None) -> str:
    """Decode every frame of ``vid_file`` to {img_folder}/%06d.png."""
    if img_folder is None:
        img_folder = osp.join("/tmp", osp.basename(vid_file).replace(".", "_"))
    os.makedirs(img_folder, exist_ok=True)

    if shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-i", vid_file, "-f", "image2", "-v", "error",
               f"{img_folder}/%06d.png"]
        subprocess.call(cmd)
        return img_folder

    try:
        import cv2

        cap = cv2.VideoCapture(vid_file)
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            i += 1
            cv2.imwrite(osp.join(img_folder, f"{i:06d}.png"), frame)
        cap.release()
        if i == 0:
            raise RuntimeError("cv2 decoded zero frames")
        return img_folder
    except Exception:
        import imageio.v2 as imageio

        reader = imageio.get_reader(vid_file)
        for i, frame in enumerate(reader, start=1):
            imageio.imwrite(osp.join(img_folder, f"{i:06d}.png"),
                            frame[..., ::-1])
        return img_folder


def extract_all(video_dir: str):
    """vid2img.py main behavior: decode every mp4 under video_dir into
    {video_dir}/images/{name}/."""
    for vid in glob.glob(osp.join(video_dir, "*.mp4")):
        name = osp.basename(vid)[:-4]
        video_to_images(vid, osp.join(video_dir, "images", name))


def main(argv=None):
    """CLI parity with ``python vid2img.py`` (reference vid2img.py:26-28):
    decode every mp4 under the internet-data root (or --video_dir)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video_dir", type=str, default=None,
                   help="directory of .mp4 files (default: INTERNET_ROOT)")
    args = p.parse_args(argv)
    video_dir = args.video_dir
    if video_dir is None:
        from dynaboa_tpu_torch.config import Paths

        video_dir = Paths().internet_root
    extract_all(video_dir)


if __name__ == "__main__":
    main()
