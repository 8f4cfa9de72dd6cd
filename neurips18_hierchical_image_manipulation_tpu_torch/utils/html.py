"""HTML gallery writer (pix2pixHD util/html.py).

The reference uses the ``dominate`` package (not available here); this is a
dependency-free writer with the same observable output: an ``index.html``
under ``{web_dir}`` with titled rows of image+caption cells, images stored
in ``{web_dir}/images``.
"""

from __future__ import annotations

import html as _html
import os


class HTML:
    def __init__(self, web_dir, title, refresh=0):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.refresh = refresh
        self.body = []
        os.makedirs(self.img_dir, exist_ok=True)

    def get_image_dir(self):
        return self.img_dir

    def add_header(self, text):
        self.body.append(f"<h3>{_html.escape(str(text))}</h3>")

    def add_images(self, ims, txts, links, width=512):
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td style='word-wrap:break-word;' halign='center' valign='top'>"
                f"<p><a href='images/{link}'><img style='width:{width}px' "
                f"src='images/{im}'></a><br>{_html.escape(str(txt))}</p></td>"
            )
        self.body.append(
            "<table border='1' style='table-layout:fixed;'><tr>"
            + "".join(cells)
            + "</tr></table>"
        )

    def save(self):
        refresh = (
            f"<meta http-equiv='refresh' content='{self.refresh}'>"
            if self.refresh
            else ""
        )
        doc = (
            "<!DOCTYPE html><html><head>"
            f"<title>{_html.escape(self.title)}</title>{refresh}</head><body>"
            + "\n".join(self.body)
            + "</body></html>"
        )
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(doc)
