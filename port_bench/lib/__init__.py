"""What the harness's entries and readers share."""
