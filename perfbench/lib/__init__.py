"""The harness: inputs, the system under test, the window, traces and the yardstick's arithmetic."""
