"""Imports of optional packages, with an error that names the package."""
import importlib


def require(module: str, feature: str):
    """Import ``module`` or raise an ImportError naming the missing package."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = module.split(".")[0]
        raise ImportError(
            f"{feature} needs the optional package {package!r}, which is not "
            "installed"
        ) from e
