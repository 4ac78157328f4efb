"""Library-wide logging setup (port of ``src/repro/obs/log.py``).

One root logger (``repro_torch``), one stderr handler, level from (in
order of precedence) an explicit ``setup_logging`` call, the
``REPRO_LOG_LEVEL`` environment variable, or the WARNING default.
Everything under ``repro_torch.*`` and ``benchmarks`` logs through here;
stdout is never touched, so machine-readable output stays clean when
piped.

Usage::

    from repro_torch.obs.log import get_logger
    log = get_logger(__name__)
    log.info("staged segment %d", seg)

CLI entry points call ``setup_logging(quiet=args.quiet,
verbose=args.verbose)`` (or ``add_log_args(parser)`` +
``setup_logging_from_args(args)``) once at startup.
"""
from __future__ import annotations

import logging
import os
import sys

ROOT = "repro_torch"
ENV_VAR = "REPRO_LOG_LEVEL"

_configured = False


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the ``repro_torch`` hierarchy (idempotent lazy
    setup)."""
    _ensure_configured()
    if not name or name == ROOT:
        return logging.getLogger(ROOT)
    if name.startswith(ROOT + ".") or name == "benchmarks" \
            or name.startswith("benchmarks."):
        return logging.getLogger(name)
    return logging.getLogger(f"{ROOT}.{name}")


def setup_logging(level: int | str | None = None, *, quiet: bool = False,
                  verbose: bool = False) -> logging.Logger:
    """Configure the ``repro_torch`` root logger (stderr handler, once).

    ``quiet`` wins over ``verbose`` wins over ``level`` wins over the
    ``REPRO_LOG_LEVEL`` environment variable wins over the WARNING
    default.
    """
    global _configured
    root = logging.getLogger(ROOT)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.propagate = False
        logging.getLogger("benchmarks").addHandler(handler)
        logging.getLogger("benchmarks").propagate = False
        _configured = True
    if quiet:
        eff: int | str = logging.ERROR
    elif verbose:
        eff = logging.DEBUG
    elif level is not None:
        eff = level
    else:
        eff = os.environ.get(ENV_VAR, "WARNING").upper()
    root.setLevel(eff)
    logging.getLogger("benchmarks").setLevel(eff)
    return root


def _ensure_configured() -> None:
    if not _configured:
        setup_logging()


def add_log_args(parser) -> None:
    """Attach the standard ``--quiet`` / ``--verbose`` pair."""
    parser.add_argument("--quiet", action="store_true",
                        help="errors only (stderr)")
    parser.add_argument("--verbose", action="store_true",
                        help="debug logging (stderr)")


def setup_logging_from_args(args) -> logging.Logger:
    return setup_logging(quiet=getattr(args, "quiet", False),
                         verbose=getattr(args, "verbose", False))
