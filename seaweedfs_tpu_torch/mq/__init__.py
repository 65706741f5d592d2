"""Message queue: brokers, partitioned topics, pub/sub; the counterpart
of seaweedfs_tpu/mq.

Equivalent of SeaweedFS weed/mq/ (broker_server.go, broker_grpc_pub.go,
broker_grpc_sub.go, mq.proto): brokers register in the cluster's
membership under their own node type, topic configuration and segment
data live in the filer (so brokers are stateless and restartable),
publishers hash keys onto partitions, subscribers replay from any
offset then follow the live tail. SeaweedFS marks the subsystem WIP;
the shape here mirrors its architecture with an HTTP transport.
"""
from .broker import BrokerServer, Topic

__all__ = ["BrokerServer", "Topic"]
