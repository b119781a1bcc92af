from repro_torch.debug.sanitize import (RecompileError, allowed_transfer,
                                        assert_no_recompiles, sanitized)

__all__ = ["RecompileError", "allowed_transfer", "assert_no_recompiles",
           "sanitized"]
