from .config import ClusterConfig, ServerInfo, round_robin_token_assignment

__all__ = ["ClusterConfig", "ServerInfo", "round_robin_token_assignment"]
