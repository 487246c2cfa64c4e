from .transport import RpcServer, RpcClientPool, ConnectionNotReady, fan_out

__all__ = ["RpcServer", "RpcClientPool", "ConnectionNotReady", "fan_out"]
