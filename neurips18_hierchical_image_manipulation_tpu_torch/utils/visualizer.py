"""Visualizer (pix2pixHD util/visualizer.py): the run's ``loss_log.txt``,
the console loss lines of training and ``save_images`` into an HTML
gallery. The training HTML displays and TensorBoard scalars wait for a
later slice."""

from __future__ import annotations

import os
import time

from .imaging import save_image


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.win_size = opt.display_winsize
        self.name = opt.name
        self.log_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self.log_name = os.path.join(self.log_dir, "loss_log.txt")
        with open(self.log_name, "a") as f:
            now = time.strftime("%c")
            f.write(f"================ Training Loss ({now}) ================\n")

    def print_current_errors(self, epoch, i, errors, t):
        """One console line, also appended to loss_log.txt."""
        message = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) "
        for k, v in errors.items():
            message += f"{k}: {float(v):.3f} "
        print(message, flush=True)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")

    def save_images(self, webpage, visuals, image_path):
        """visuals: dict name -> uint8 HWC image; one gallery row per call."""
        image_dir = webpage.get_image_dir()
        short_path = os.path.basename(str(image_path))
        name = os.path.splitext(short_path)[0]
        webpage.add_header(name)
        ims, txts, links = [], [], []
        for label, image in visuals.items():
            image_name = f"{name}_{label}.png"
            save_image(image, os.path.join(image_dir, image_name))
            ims.append(image_name)
            txts.append(label)
            links.append(image_name)
        webpage.add_images(ims, txts, links, width=self.win_size)
