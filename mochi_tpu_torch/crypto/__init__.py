from .keys import KeyPair, generate_keypair, sign, verify

__all__ = ["KeyPair", "generate_keypair", "sign", "verify"]
