"""The img2txt workload (captioning and VQA), a copy of
``chiaswarm_tpu/workloads/caption.py``.

A ``parameters.model_type`` containing "QuestionAnswering" (the hive's
``BlipForQuestionAnswering``) answers the prompt; otherwise a prompt
conditions the caption and no prompt captions plainly. The result is a JSON
text artifact. Any failure becomes an error *artifact* with the message in
the config, not a failed job, as in the reference: a captioning failure
must not poison a node. The pipeline comes resident from the registry on
the slot's lead device (``pipelines/caption.py``).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from chiaswarm_tpu_torch.node.output_processor import make_text_result


def caption_callback(slot, model_name: str, *, seed: int,
                     image: np.ndarray | None = None,
                     prompt: str = "",
                     parameters: dict[str, Any] | None = None,
                     registry=None,
                     **_ignored: Any):
    config: dict[str, Any] = {"model_name": model_name}
    try:
        if image is None:
            raise ValueError("img2txt requires start_image_uri")
        if registry is None:
            raise ValueError("img2txt requires a model registry")
        parameters = parameters or {}
        t0 = time.monotonic()
        pipeline = registry.caption_pipeline(
            model_name, mesh=getattr(slot, "mesh", None))
        wants_vqa = "QuestionAnswering" in str(
            parameters.get("model_type", ""))
        caption = pipeline(np.asarray(image), prompt or "", vqa=wants_vqa)
        config["caption"] = caption
        config["elapsed_s"] = round(time.monotonic() - t0, 3)
        return {"primary": make_text_result(caption)}, config
    except Exception as exc:  # an error artifact, not a failed job
        config["error"] = str(exc)
        return {"primary": make_text_result(str(exc))}, config
