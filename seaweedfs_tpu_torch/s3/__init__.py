"""S3 gateway: AWS-S3-compatible REST API over the filer; the
counterpart of seaweedfs_tpu/s3/ — server.py (routing + the core
handlers), auth.py (SigV4 + V2 + the identity model) and chunked.py
(aws-chunked bodies).
"""
from .auth import (IdentityAccessManagement, S3AuthError, presign_url,
                   sign_request)
from .server import S3ApiServer, S3Error

__all__ = ["IdentityAccessManagement", "S3AuthError", "presign_url",
           "sign_request", "S3ApiServer", "S3Error"]
