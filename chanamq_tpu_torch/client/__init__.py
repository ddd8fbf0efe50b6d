"""Conformance/bench AMQP client.

The reference relied on the official RabbitMQ Java client for its manual
conformance tests (chana-mq-test SimplePublisher/SimpleConsumer,
Build.scala:105-107). No third-party AMQP client exists in this environment,
so the framework ships its own asyncio client — it doubles as the public
client API and as the conformance/bench harness (tests/, bench.py).
"""

from .client import AMQPClient, ClientChannel, DeliveredMessage

__all__ = ["AMQPClient", "ClientChannel", "DeliveredMessage"]
