"""Input pipeline of the port: its own numpy copies of the JAX package's
data modules (``io_util``, ``augment``, ``s3dis``, ``scannet``,
``semantic3d``, ``modelnet``, ``synth_rooms``, ``toy``, ``batching``), the
native host library's binding (``native``), and the background-thread
``Provider`` with the device transfer (``provider``).  ``blocks_fn_for`` and
``read_fn_for`` pick a config's reader of prepared pkls for the train CLI
and the scene eval; a model with inputs beyond the block names its own
(``train.model_zoo.read_fn_for``)."""
from functools import partial

from . import io_util, modelnet, s3dis, scannet, semantic3d


def blocks_fn_for(cfg, config_name: str):
    """(model, loaded pkl) -> block dicts for the config's dataset: S3DIS
    rooms (rgb, with the covariance features when the config's feat_dim is
    above 3), ScanNet scenes (geometry only) or Semantic3D training blocks
    (rgb, intensity and covariance features)."""
    return {
        "s3dis": partial(s3dis.blocks_from_room,
                         use_covars=cfg.data.feat_dim > 3),
        "scannet": scannet.blocks_from_scene,
        "semantic3d": semantic3d.blocks_from_list,
    }[config_name]


def read_fn_for(cfg, config_name: str):
    """The Provider read_fn of the config's dataset: (model, pkl path) ->
    block dicts, as ``blocks_fn_for`` builds them; for ModelNet40 one cloud
    dict per ``(xyz, label)`` pair (``modelnet.clouds_from_pkl``)."""
    if config_name == "modelnet40":
        return modelnet.clouds_from_pkl
    return pkl_read_fn(blocks_fn_for(cfg, config_name))


def pkl_read_fn(blocks_fn):
    """A Provider read_fn (model, pkl path) -> block dicts: ``blocks_fn``
    on the loaded pkl."""
    return partial(_read, blocks_fn)


def _read(blocks_fn, model: str, filename: str):
    return blocks_fn(model, io_util.read_pkl(filename))
