"""Minimal HTML gallery writer (reference util/html.py:6-64, sans dominate):
``index.html`` with a header per sample and an image table with captions
and links into ``images/``."""

from __future__ import annotations

import os
from typing import List, Sequence


class HTML:
    def __init__(self, web_dir: str, title: str):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self._body: List[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str):
        self._body.append(f"<h3>{text}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int = 400):
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                '<td style="word-wrap:break-word" halign="center" valign="top">'
                f'<p><a href="images/{link}">'
                f'<img style="width:{width}px" src="images/{im}"></a><br>'
                f"{txt}</p></td>"
            )
        self._body.append(
            '<table border="1" style="table-layout:fixed">'
            f"<tr>{''.join(cells)}</tr></table>"
        )

    def save(self):
        doc = (f"<!DOCTYPE html><html><head><title>{self.title}</title>"
               f"</head><body>{''.join(self._body)}</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "wt") as fh:
            fh.write(doc)
