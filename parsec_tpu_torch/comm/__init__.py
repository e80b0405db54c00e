"""Distribution on the task path: comm engines (in-process threads, TCP
between processes, the native lane), the remote-dependency protocol, and
the device-resident payload planes (``d2d`` within a process, ``xhost``
between processes on one host)."""
