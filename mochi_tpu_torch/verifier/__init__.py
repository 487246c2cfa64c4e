from .spi import VerifyItem, SignatureVerifier, CpuVerifier, BatchingVerifier

__all__ = ["VerifyItem", "SignatureVerifier", "CpuVerifier", "BatchingVerifier"]
