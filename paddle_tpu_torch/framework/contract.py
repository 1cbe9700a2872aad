"""Reference parameters the port takes but does not implement.

Every public callable of the port keeps the JAX package's positional
parameters in their order, with their names and defaults; a parameter the
port has not got raises here when it is set to anything but its default
(``tests/test_torch_signatures.py``).
"""

from __future__ import annotations


def _is_default(value, default) -> bool:
    if value is default:
        return True
    scalars = (bool, int, float, str)
    return (isinstance(value, scalars) and isinstance(default, scalars)
            and isinstance(value, bool) == isinstance(default, bool)
            and value == default)


def refuse_unported(owner: str, **params) -> None:
    """Raise ``NotImplementedError`` naming the first of ``params``
    (name -> (value, default)) that is set away from its default."""
    for name, (value, default) in params.items():
        if not _is_default(value, default):
            raise NotImplementedError(
                f"{owner}: {name}={value!r} is not ported to "
                f"paddle_tpu_torch (only {name}={default!r} is)")
