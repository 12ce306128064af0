"""Dataset readers: LRS-GRO RL jsonl + SFT records (reference data formats, SURVEY.md §2.5)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Sequence


@dataclasses.dataclass
class LRSGROSample:
    """One row of dataset/LRS_GRO/rl.jsonl (fields verified in SURVEY.md §2.5)."""

    question_id: str
    image_name: str
    category: str
    question: str
    higher_level: str
    ground_truth: str
    bbox: List[float]  # [] for global questions, full-res pixels otherwise
    type: str  # global / region / object
    split: str = ""
    image_path: Optional[str] = None


def _lrs_gro_rows(path: str):
    """Row dicts from a jsonl file OR an HF dataset directory (auto-detected) —
    the reference uses BOTH formats: rl.jsonl for training (grpo_jsonl.py:961-974)
    and a saved HF dataset for the eval split (infer.py:91 load_from_disk)."""
    if os.path.isdir(path):
        yield from _load_hf_split(path)
        return
    with open(path) as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def _load_hf_split(path: str):
    """load_from_disk that gives an actionable error for DatasetDict directories
    (iterating one yields split-name STRINGS — a confusing AttributeError later)."""
    from datasets import DatasetDict, load_from_disk

    ds = load_from_disk(path)
    if isinstance(ds, DatasetDict):
        raise ValueError(
            f"{path} is a DatasetDict with splits {list(ds)}; pass the split "
            f"subdirectory instead (e.g. {os.path.join(path, list(ds)[0])})"
        )
    return ds


def load_lrs_gro_jsonl(paths: Sequence[str], image_folders: Sequence[str]) -> List[LRSGROSample]:
    """Load `:`-separated datasets (jsonl files or HF dataset dirs) joined with
    their image folders (reference grpo_jsonl.py:961-974: image_name -> image_path
    under the folder)."""
    assert len(paths) == len(image_folders), "one image folder per dataset"
    out: List[LRSGROSample] = []
    for path, folder in zip(paths, image_folders):
        for d in _lrs_gro_rows(path):
                out.append(
                    LRSGROSample(
                        question_id=str(d.get("question_id", "")),
                        image_name=d.get("image_name", ""),
                        category=d.get("category", ""),
                        question=d.get("question", ""),
                        higher_level=d.get("higher_level", ""),
                        ground_truth=d.get("ground_truth", ""),
                        bbox=d.get("bbox", []) or [],
                        type=d.get("type", ""),
                        split=d.get("split", ""),
                        image_path=os.path.join(folder, os.path.basename(d.get("image_name", ""))),
                    )
                )
    return out


@dataclasses.dataclass
class SFTSample:
    """One row of the SFT dataset (reference SFT.py:133-170 field usage)."""

    question: str
    cut: bool
    global_desc: str  # 'global' field: scene description
    stage_1_reasoning: str
    area: str  # 9-way location word
    bbox: List[float]
    stage_2_reasoning: str
    ground_truth: str
    image_name: str
    image_path: Optional[str] = None


def load_sft_jsonl(path: str, image_folder: str) -> List[SFTSample]:
    out: List[SFTSample] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            out.append(
                SFTSample(
                    question=d.get("question", ""),
                    cut=bool(d.get("cut", False)),
                    global_desc=d.get("global", ""),
                    stage_1_reasoning=d.get("stage_1_reasoning", ""),
                    area=d.get("area", ""),
                    bbox=d.get("bbox", []) or [],
                    stage_2_reasoning=d.get("stage_2_reasoning", ""),
                    ground_truth=d.get("ground_truth", ""),
                    image_name=d.get("image_name", ""),
                    image_path=os.path.join(image_folder, os.path.basename(d.get("image_name", ""))),
                )
            )
    return out


def load_sft_hf(path: str, image_folder: str) -> List[SFTSample]:
    """SFT rows from an HF dataset directory (`datasets.load_from_disk`) — the
    reference's actual storage format (SFT.py:181 `load_from_disk(dataset_path)`),
    so a checkpointed reference dataset drops in unconverted. Same field mapping as
    load_sft_jsonl (SFT.py:133-170)."""
    ds = _load_hf_split(path)
    out: List[SFTSample] = []
    for d in ds:
        out.append(
            SFTSample(
                question=d.get("question", ""),
                cut=bool(d.get("cut", False)),
                global_desc=d.get("global", ""),
                stage_1_reasoning=d.get("stage_1_reasoning", ""),
                area=d.get("area", ""),
                bbox=list(d.get("bbox", []) or []),
                stage_2_reasoning=d.get("stage_2_reasoning", ""),
                ground_truth=d.get("ground_truth", ""),
                image_name=d.get("image_name", ""),
                image_path=os.path.join(image_folder, os.path.basename(d.get("image_name", ""))),
            )
        )
    return out


def load_sft_dataset(path: str, image_folder: str) -> List[SFTSample]:
    """Auto-detect: HF dataset directory (reference format) vs jsonl file."""
    if os.path.isdir(path):
        return load_sft_hf(path, image_folder)
    return load_sft_jsonl(path, image_folder)


def batched(seq: Sequence, batch_size: int, *, drop_last: bool = False) -> Iterator[list]:
    batch = []
    for item in seq:
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch
