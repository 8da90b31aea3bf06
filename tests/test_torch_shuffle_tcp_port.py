"""The port's TCP transport (``shuffle/tcp_port.py``) where the reference's
server send can beat a peer's hello (ROADMAP queue 3 item 14): the JAX
package's test of scoped peer loss, as written, passes against it every
run."""
import pytest

from spark_rapids_tpu_torch.config import TpuConf


@pytest.mark.parametrize("run", range(20))
def test_peer_loss_scoped_to_failing_peer_sends_before_the_hello(tmp_path,
                                                                  run):
    """ROADMAP queue 3 item 14: the JAX package's
    ``tests/test_shuffle_faults.py::test_peer_loss_scoped_to_failing_peer``
    as written, against the port's transport: c's server sends to a
    without waiting for a's hello on the socket a dialed. The reference's
    send may beat the hello and fail, and a's receive then times out; the
    port's send waits for the hello on that socket (bounded by
    ``shuffle.connectTimeout``) and the receive completes, every run."""
    from spark_rapids_tpu_torch.shuffle.tcp_port import TcpTransport
    from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                          TransactionStatus)
    conf = TpuConf({
        "spark.rapids.tpu.shuffle.transport.class":
            "spark_rapids_tpu_torch.shuffle.tcp_port.TcpTransport",
        "spark.rapids.tpu.shuffle.tcp.registryDir": str(tmp_path / "reg")})
    a = TcpTransport("exec-a", conf)
    b = TcpTransport("exec-b", conf)
    c = TcpTransport("exec-c", conf)
    try:
        conn_b = a.connect("exec-b")
        conn_c = a.connect("exec-c")
        lost = []
        a.add_peer_lost_listener(lost.append)
        # one pending receive per peer; kill b — only b's must fail
        rb = conn_b.receive(AddressLengthTag(bytearray(5), 5, tag=0x10),
                            lambda t: None)
        alt_c = AddressLengthTag(bytearray(5), 5, tag=0x20)
        rc = conn_c.receive(alt_c, lambda t: None)
        b.shutdown()
        rb.wait(10)
        assert rb.status is TransactionStatus.ERROR
        assert "lost" in rb.error_message
        # c's receive is untouched and still completes
        assert rc.status is TransactionStatus.IN_PROGRESS
        c.server.send("exec-a", AddressLengthTag.for_bytes(b"hello", 0x20),
                      lambda t: None).wait(10)
        rc.wait(10)
        assert rc.status is TransactionStatus.SUCCESS
        assert bytes(alt_c.buffer) == b"hello"
        assert lost == ["exec-b"]
    finally:
        a.shutdown()
        c.shutdown()
