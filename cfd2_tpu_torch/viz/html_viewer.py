"""Standalone interactive HTML viewer for simulation runs.

The reference's GUI equivalence target (SURVEY.md §7: "interactive
notebook/web viewer, not egui"): rendered frames embed into a single
self-contained HTML file with a time scrubber, play/pause, and field
metadata — no server, no network, opens anywhere.
"""

from __future__ import annotations

import base64
import html
import io
import json


def write_html_viewer(path: str, frames: list, title: str = "cfd2_tpu run",
                      metadata: dict | None = None) -> None:
    """Write an interactive viewer.

    ``frames``: list of (label, png_bytes) or (label, matplotlib_figure).
    """
    imgs = []
    labels = []
    for label, frame in frames:
        if hasattr(frame, "savefig"):
            buf = io.BytesIO()
            frame.savefig(buf, format="png", bbox_inches="tight")
            data = buf.getvalue()
        else:
            data = frame
        imgs.append(base64.b64encode(data).decode("ascii"))
        labels.append(str(label))

    meta_rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td><td>{html.escape(str(v))}</td></tr>"
        for k, v in (metadata or {}).items())

    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1.5rem; background: #111; color: #eee; }}
 img {{ max-width: 100%; border: 1px solid #333; }}
 table {{ border-collapse: collapse; margin-top: 1rem; }}
 td {{ border: 1px solid #333; padding: 2px 10px; }}
 .bar {{ display: flex; gap: 1rem; align-items: center; margin: 0.5rem 0; }}
 input[type=range] {{ flex: 1; }}
</style></head><body>
<h2>{html.escape(title)}</h2>
<div class="bar">
  <button id="play">&#9658;</button>
  <input type="range" id="scrub" min="0" max="{len(imgs) - 1}" value="0">
  <span id="label"></span>
</div>
<img id="frame">
<table>{meta_rows}</table>
<script>
const imgs = {json.dumps(imgs)};
const labels = {json.dumps(labels)};
const img = document.getElementById("frame");
const scrub = document.getElementById("scrub");
const label = document.getElementById("label");
const play = document.getElementById("play");
let timer = null;
function show(i) {{
  img.src = "data:image/png;base64," + imgs[i];
  label.textContent = labels[i];
  scrub.value = i;
}}
scrub.addEventListener("input", () => show(+scrub.value));
play.addEventListener("click", () => {{
  if (timer) {{ clearInterval(timer); timer = null; play.innerHTML = "&#9658;"; return; }}
  play.innerHTML = "&#10074;&#10074;";
  timer = setInterval(() => show((+scrub.value + 1) % imgs.length), 200);
}});
show(0);
</script></body></html>"""
    with open(path, "w") as f:
        f.write(doc)
