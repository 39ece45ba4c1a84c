import sys

from cardbench.run import main

if __name__ == "__main__":
    sys.exit(main())
