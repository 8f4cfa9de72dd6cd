"""Visualizer (pix2pixHD util/visualizer.py) — counterpart of
``utils/visualizer.py`` in the JAX package: the run's ``loss_log.txt`` and
console loss lines, the training HTML page (``display_current_results``,
JAX ``:42``: ``web/images/epoch{NNN}_{label}.png`` and ``web/index.html``
listing the epochs newest first, every ``--display_freq`` steps) and
``save_images`` into a test gallery. ``plot_current_errors`` (JAX ``:67``)
writes TensorBoard scalars under ``--tf_log``, which the port refuses
(TensorBoard is not installed), so it has nothing to write.
"""

from __future__ import annotations

import os
import time

from . import html as html_mod
from .imaging import save_image


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.use_html = opt.isTrain and not getattr(opt, "no_html", False)
        self.win_size = opt.display_winsize
        self.name = opt.name
        self.log_dir = os.path.join(opt.checkpoints_dir, opt.name)
        if self.use_html:
            self.web_dir = os.path.join(self.log_dir, "web")
            self.img_dir = os.path.join(self.web_dir, "images")
            os.makedirs(self.img_dir, exist_ok=True)
        self.log_name = os.path.join(self.log_dir, "loss_log.txt")
        with open(self.log_name, "a") as f:
            now = time.strftime("%c")
            f.write(f"================ Training Loss ({now}) ================\n")

    def display_current_results(self, visuals, epoch, step):
        """visuals: dict name -> uint8 HWC image, saved as this epoch's row
        of the training page."""
        if not self.use_html:
            return
        for label, image in visuals.items():
            save_image(image, os.path.join(self.img_dir, f"epoch{epoch:03d}_{label}.png"))
        webpage = html_mod.HTML(self.web_dir, f"Experiment name = {self.name}", refresh=30)
        for n in range(epoch, 0, -1):
            webpage.add_header(f"epoch [{n}]")
            ims = [f"epoch{n:03d}_{label}.png" for label in visuals]
            kept = [(im, label) for im, label in zip(ims, visuals)
                    if os.path.exists(os.path.join(self.img_dir, im))]
            if kept:
                webpage.add_images([im for im, _ in kept], [lb for _, lb in kept],
                                   [im for im, _ in kept], width=self.win_size)
        webpage.save()

    def plot_current_errors(self, errors, step):
        """TensorBoard scalars under --tf_log: refused by the port's options,
        so there is no writer."""

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
