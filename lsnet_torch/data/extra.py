"""Dataset registry (counterpart of ``lsnet_tpu/data/extra.py``
``DATASET_TYPES`` / ``build_dataset``), with its two COCO entries:
``CocoDataset`` and ``CocoPoseDataset``, the pose files' type, which is
the same dataset (the person-only filter follows ``DatasetConfig.task``,
``data/coco.py``). The JAX registry's VOC, WIDER Face, Cityscapes,
DeepFashion and LVIS datasets are ROADMAP Queue 1 "Inherited zoo" item
3.4."""

from __future__ import annotations

from .coco import CocoDataset, DatasetConfig

DATASET_TYPES = {
    "CocoDataset": CocoDataset,
    "CocoPoseDataset": CocoDataset,   # person_only switch lives in cfg.task
}


def build_dataset(type_name: str, cfg: DatasetConfig,
                  test_mode: bool = False) -> CocoDataset:
    """Registry-style dataset construction (reference ``build_dataset``);
    an unknown type raises ``KeyError``."""
    if type_name not in DATASET_TYPES:
        raise KeyError(f"unknown dataset type {type_name!r}; "
                       f"known: {sorted(DATASET_TYPES)}")
    return DATASET_TYPES[type_name](cfg, test_mode=test_mode)
