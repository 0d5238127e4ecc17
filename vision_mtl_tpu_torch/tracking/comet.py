"""Comet experiment tracking (counterpart of
``vision_mtl_tpu/tracking/comet.py``), optional as there: without
``comet_ml`` or without the credentials (``cfg.logger``), or with
``--exp_disabled``, :func:`create_tracking_exp` returns a
:class:`NullExperiment`, which is falsy and absorbs every call, so the
``if exp:`` guards of the call sites skip their logging. ``comet_ml`` is
imported inside the functions that use it.
"""

from __future__ import annotations

import argparse
import glob
import typing as t

from vision_mtl_tpu_torch.cfg import cfg


class NullExperiment:
    """A no-op experiment: falsy, and every method returns None."""

    name = "disabled"

    def __bool__(self) -> bool:
        return False

    def _noop(self, *args: t.Any, **kwargs: t.Any) -> None:
        return None

    def __getattr__(self, item: str) -> t.Callable[..., None]:
        return self._noop


# a failed import is not cached by Python, and comet_enabled is asked every
# validation epoch: probe once per process
_comet_importable: t.Optional[bool] = None


def comet_enabled(args: argparse.Namespace) -> bool:
    """Would :func:`create_tracking_exp` return a real experiment? Decided
    from the args, the config and whether ``comet_ml`` imports."""
    if getattr(args, "exp_disabled", True) or cfg.logger.disabled:
        return False
    global _comet_importable
    if _comet_importable is None:
        try:
            import comet_ml  # noqa: F401

            _comet_importable = True
        except ImportError:
            _comet_importable = False
    return _comet_importable


def create_tracking_exp(
    args: argparse.Namespace,
    exp_disabled: bool = True,
    force_disabled: t.Optional[bool] = None,
    project_name: t.Optional[str] = None,
) -> t.Any:
    """A comet ``Experiment`` (an ``ExistingExperiment`` under
    ``args.resume_exp``), or a :class:`NullExperiment` when tracking is
    disabled or ``comet_ml`` is not installed."""
    if force_disabled is None:
        force_disabled = cfg.logger.disabled
    if project_name is None:
        project_name = cfg.logger.project_name
    disabled = getattr(args, "exp_disabled", exp_disabled) or force_disabled
    if disabled:
        # comet_ml.Experiment(disabled=True) is truthy and would flip every
        # ``if exp:`` guard to the enabled path
        return NullExperiment()

    try:
        import comet_ml
    except ImportError:
        return NullExperiment()

    exp_init_args = dict(
        api_key=cfg.logger.api_key,
        auto_output_logging="simple",
        auto_metric_logging=True,
        auto_param_logging=True,
        log_env_details=True,
        log_env_host=False,
        log_env_gpu=True,
        log_env_cpu=True,
        log_code=False,
        disabled=disabled,
    )
    if getattr(args, "resume_exp", False):
        from comet_ml.api import API

        api = API(api_key=cfg.logger.api_key)
        exp_api = api.get(f"{cfg.logger.username}/{project_name}/{args.exp_name}")
        experiment = comet_ml.ExistingExperiment(**exp_init_args, experiment_key=exp_api.id)
    else:
        experiment = comet_ml.Experiment(**exp_init_args, project_name=project_name)
    for code_file in glob.glob("./*.py"):
        experiment.log_code(code_file)
    return experiment


def log_params_to_exp(experiment: t.Any, params: dict, prefix: str) -> None:
    if experiment:
        experiment.log_parameters({f"{prefix}/{str(k)}": v for k, v in params.items()})


def log_ckpt_to_exp(experiment: t.Any, ckpt_path: str, model_name: str = "ckpt") -> None:
    if experiment:
        experiment.log_model(model_name, ckpt_path, overwrite=False)
