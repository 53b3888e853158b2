from fugu_tpu_torch.server.app import create_app, start_http_server

__all__ = ["create_app", "start_http_server"]
