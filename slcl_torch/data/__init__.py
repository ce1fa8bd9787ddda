from .loader import Loader, device_prefetch, to_device, zip_domains  # noqa: F401
from .synthetic import SyntheticCardiacDataset  # noqa: F401


def prepare_datasets(cfg):
    """Dataset factory keyed by ``cfg.data.dataset``: ``synthetic``,
    ``mmwhs`` (raw NIfTI or preprocessed PNG, ``data.raw``) or ``mscmrseg``
    (reference prepare_dataset variants, SURVEY §2.6)."""
    name = cfg.data.dataset
    if name == "synthetic":
        S = SyntheticCardiacDataset
        n = 8 * cfg.data.bs
        src, trg = ("mr", "ct") if cfg.data.rev else ("ct", "mr")
        g = cfg.data.gap
        return {
            "train_s": S(n, cfg.data.crop, src, cfg.data.seed,
                         augmentation=cfg.data.aug_s, vert=cfg.data.vert, gap=g),
            "train_t": S(n, cfg.data.crop, trg, cfg.data.seed + 1,
                         augmentation=cfg.data.aug_t,
                         aug_counter=cfg.data.aug_counter, gap=g,
                         aug_mode=cfg.data.aug_mode),
            "valid_t": S(2 * cfg.data.eval_bs, cfg.data.crop, trg,
                         cfg.data.seed + 2, gap=g),
            "test_t": S(2 * cfg.data.eval_bs, cfg.data.crop, trg,
                        cfg.data.seed + 3, gap=g),
            "test_s": S(2 * cfg.data.eval_bs, cfg.data.crop, src,
                        cfg.data.seed + 4, gap=g),
        }
    if name == "mmwhs":
        from .mmwhs import prepare_datasets_mmwhs
        return prepare_datasets_mmwhs(cfg)
    if name == "mscmrseg":
        from .mscmrseg import prepare_datasets_mscmrseg
        return prepare_datasets_mscmrseg(cfg)
    raise ValueError(f"unknown dataset {name!r}")
