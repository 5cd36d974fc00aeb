"""Prompt-engineering helpers for zero-shot classification.

The port's copy of ``openvision_tpu/evaluators/prompts.py``: class-name
canonicalization and the CLIP paper/best prompt template sets (data in
in1k_classes.py).
"""

from __future__ import annotations

from typing import List, Sequence

from openvision_tpu_torch.evaluators.in1k_classes import (
    CLIP_BEST_PROMPT_TEMPLATES,
    CLIP_IMAGENET_CLASS_NAMES,
    CLIP_PAPER_PROMPT_TEMPLATES,
)

PROMPT_SETS = {
    "clip_paper": CLIP_PAPER_PROMPT_TEMPLATES,
    "clip_best": CLIP_BEST_PROMPT_TEMPLATES,
    "none": ["{}"],
    "simple": ["a photo of a {}"],
}

CLASS_NAME_SETS = {
    "imagenet2012": CLIP_IMAGENET_CLASS_NAMES,
    "clip": CLIP_IMAGENET_CLASS_NAMES,
}


def canonicalize_text(text: str) -> str:
    """Underscores → spaces, collapse whitespace, strip."""
    text = text.replace("_", " ").replace("-", " ")
    return " ".join(text.split()).strip()


def get_class_names(
    dataset_name: str = "imagenet2012",
    source: str = "clip",
    canonicalize: bool = True,
    first_class_name_only: bool = False,
) -> List[str]:
    names = CLASS_NAME_SETS.get(source, CLASS_NAME_SETS["clip"])
    out = []
    for n in names:
        if first_class_name_only and "," in n:
            n = n.split(",")[0]
        out.append(canonicalize_text(n) if canonicalize else n)
    return out


def get_prompt_templates(prompt_names: str = "clip_paper") -> Sequence[str]:
    return PROMPT_SETS[prompt_names]
